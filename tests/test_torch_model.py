"""The port's decoder against the reference's ``Model``, for every
registered arch (qk-norm, qkv bias, a head_dim other than d_model /
heads, the audio decoder, mixture-of-experts with its aux loss, RWKV6,
the Mamba hybrid stack with MoE every other layer, and the VLM with its
cross-attention fed the same image embeddings on both sides) and the
sliding, chunked and FULL-every-k attention variants.

Both sides get the same weights, made with numpy from a seed in the
reference's ``Model.init`` layout (biases at unit scale, so that they
matter); ``from_jax_params`` carries them over.  The flat parameter
vector must equal ``ravel_pytree(params)``
exactly (the wire's bucket membership depends on that order), and the
loss and the flat gradient must agree with ``jax.value_and_grad``.
Tolerances: loss rtol 1e-5; gradient within 1e-4 of its largest entry
(float32 throughout, but attention, softmax and matmul sums run in
another order and through other kernels).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.models import Model as JModel
from repro_torch import configs
from repro_torch.models.transformer import Model
from repro_torch.weights import from_jax_params

# one thread: xdist workers that each take every core starve one another
torch.set_num_threads(1)

# (arch, smoke, fields replaced on both sides): every registered arch,
# and the attention variants on one SMOKE config: a sliding window below
# the sequence, chunks with a trailing partial chunk, and chunked layers
# with every second one FULL (group_size 2, two groups)
VARIANTS = {
    "sliding": dict(attn_kind="sliding", window=8),
    "chunked": dict(attn_kind="chunked", chunk=12),
    "full_every_2": dict(attn_kind="chunked", chunk=12, full_attn_every=2,
                         num_layers=4),
}
CASES = ([("paper-proxy", False, None)]
         + [(a, True, None) for a in configs.ARCH_NAMES]
         + [("llama3.2-1b", True, v) for v in VARIANTS])


def _ravel(tree):
    """``ravel_pytree``'s order (sorted dict keys, list order), in numpy."""
    return np.concatenate([np.asarray(x, np.float32).reshape(-1)
                           for x in jax.tree.leaves(tree)])


def _jax_loss_and_grad(jcfg, params, batch):
    model = JModel(jcfg, tp=1, dp=1)
    pspecs = model.param_specs()
    bspec = {k: P("data") for k in batch}

    def f(p, b):
        return jax.value_and_grad(lambda q: model.loss(q, b))(p)

    with jax.set_mesh(jax.make_mesh((1, 1), ("data", "model"))):
        fn = jax.jit(jax.shard_map(f, in_specs=(pspecs, bspec),
                                   out_specs=(P(), pspecs),
                                   check_vma=False))
        return fn(params, batch)


def _pair(arch, smoke, variant):
    jcfg = (jconfigs.get_smoke_config(arch) if smoke
            else jconfigs.get_config(arch))
    cfg = (configs.get_smoke_config(arch) if smoke
           else configs.get_config(arch))
    if variant:
        jcfg = dataclasses.replace(jcfg, **VARIANTS[variant])
        cfg = dataclasses.replace(cfg, **VARIANTS[variant])
    # every field of the reference's config is equal; the port's one field
    # of its own (the card's share of the experts) is at its default, the
    # whole layer
    jfields = {f.name for f in dataclasses.fields(jcfg)}
    for f in dataclasses.fields(cfg):
        if f.name in jfields:
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        else:
            assert f.name == "experts_held", f.name
            assert getattr(cfg, f.name) == f.default == 0
    assert jfields <= {f.name for f in dataclasses.fields(cfg)}
    assert jcfg.param_dtype == "float32"
    assert jcfg.group_size == cfg.group_size
    return jcfg, cfg


def _random_params(jcfg, seed=0):
    """Weights from numpy in the reference's ``Model.init`` layout: matrices
    at 1/sqrt(fan-in), the embedding at unit scale, norm gains near 1.
    RWKV6's time-mix as a trained one has it: token-shift mixes in [0, 1],
    w0 in [-4, -0.5] and a LoRA within about +-0.5, so that its log decays
    stay within -0.01 to -1 a token (larger ones overflow the reference's
    masked ``exp`` in both packages; ``test_torch_rwkv.py``).  Mamba's
    A_log near the init's log(1..d_state); its conv weights and the cross
    gate, zero at init, drawn like the rest, so that neither block's
    output is 0."""
    shapes = jax.eval_shape(JModel(jcfg, tp=1, dp=1).init,
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        z = rng.standard_normal(x.shape).astype(np.float32)
        name = jax.tree_util.keystr(path)
        if "norm" in name or "ln_x" in name:
            return 1.0 + 0.1 * z
        if "mu_" in name:
            return rng.uniform(0, 1, x.shape).astype(np.float32)
        if "'w0'" in name:
            return rng.uniform(-4, -0.5, x.shape).astype(np.float32)
        if "w_lora_b" in name:
            return 0.2 * z / np.sqrt(x.shape[-2])
        if "A_log" in name:
            return (np.log(np.arange(1, x.shape[-1] + 1))
                    + 0.1 * z).astype(np.float32)
        return z if "embed" in name else z / np.sqrt(x.shape[-2])

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.mark.parametrize("arch,smoke,variant", CASES)
def test_loss_and_flat_gradient_match_reference(arch, smoke, variant):
    jcfg, cfg = _pair(arch, smoke, variant)
    np_params = _random_params(jcfg)
    params = jax.tree.map(jnp.asarray, np_params)
    flat = from_jax_params(np_params, cfg)
    np.testing.assert_array_equal(flat.numpy(), _ravel(np_params))

    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 33)).astype(np.int32)
    batch = {"ids": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.cross_attn_every:
        batch["vision"] = rng.standard_normal(
            (2, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    jloss, jgrads = _jax_loss_and_grad(
        jcfg, params, {k: jnp.asarray(v) for k, v in batch.items()})
    want_grad = _ravel(jgrads)

    model = Model(cfg, device="cpu")
    model.load_flat(flat)
    grad = torch.zeros(model.d)
    model.attach_grads(grad)
    vision = batch.get("vision")
    loss = model.loss(torch.from_numpy(batch["ids"]).long(),
                      torch.from_numpy(batch["labels"]).long(),
                      None if vision is None else torch.from_numpy(vision))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    err = np.abs(grad.numpy() - want_grad).max()
    assert err <= 1e-4 * np.abs(want_grad).max(), err

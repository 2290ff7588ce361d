"""Activation rematerialization and the chunked LM-head loss of the port.

``lm_head_loss`` and its gradients are held against the reference's
(``repro.models.layers.lm_head_loss`` inside a one-device shard_map) at
S = 1024 (two chunks of 512), S = 768 (``S % 512``: one chunk) and S =
256, with the same numpy inputs: loss rtol 1e-6, gradients within 1e-6 of
their largest entry (float32; XLA sums in another order).

``Model(remat=...)``: for one SMOKE config of every family (dense, MoE,
RWKV6, the Mamba hybrid with its 8-slot groups, the VLM with image
embeddings and its 5-slot groups, and a dense config of two-slot groups),
the loss and the flat gradient under ``"full"``, ``"dots"`` and
``"psum"`` must equal ``"none"``'s bit for bit; serving's prefill and
decode, which never checkpoint, must equal across modes too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.models.layers import TPCtx
from repro.models.layers import lm_head_loss as jlm_head_loss
from repro_torch import configs
from repro_torch.models.layers import lm_head_loss
from repro_torch.models.transformer import REMAT_MODES, Model

# one thread: xdist workers that each take every core starve one another
torch.set_num_threads(1)

V, D = 384, 32


@pytest.fixture(scope="module")
def reference_loss():
    """The reference's loss and its gradients for (w, x) at any S, one
    compiled program a shape."""
    ctx = TPCtx(model_axis="model", data_axes=("data",), tp=1, dp=1,
                compute_dtype=jnp.float32)

    def f(w, x, labels):
        return jax.value_and_grad(
            lambda w_, x_: jlm_head_loss(ctx, w_, x_, labels, V),
            argnums=(0, 1))(w, x)

    mesh = jax.make_mesh((1, 1), ("data", "model"))
    with jax.set_mesh(mesh):
        return jax.jit(jax.shard_map(
            f, in_specs=(P(), P(), P()), out_specs=(P(), (P(), P())),
            check_vma=False))


@pytest.mark.parametrize("S", [1024, 768, 256])
def test_lm_head_loss_matches_reference(reference_loss, S):
    rng = np.random.default_rng(S)
    B = 2
    w = (rng.standard_normal((D, V)) * D ** -0.5).astype(np.float32)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    with jax.set_mesh(jax.make_mesh((1, 1), ("data", "model"))):
        jl, (jgw, jgx) = reference_loss(w, x, labels)
    tw = torch.from_numpy(w).requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    loss = lm_head_loss(tw, tx, torch.from_numpy(labels).long())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    for got, want in ((tw.grad, jgw), (tx.grad, jgx)):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max()
        assert err <= 1e-6 * np.abs(want).max(), err


def test_chunked_loss_is_the_unchunked_loss_summed_in_order():
    """Two chunks against the chunk sums taken by hand, bit for bit, and
    the whole-sequence loss (one chunk) within float32 rounding."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn((D, V), generator=g)
    x = torch.randn((2, 1024, D), generator=g)
    labels = torch.randint(0, V, (2, 1024), generator=g)
    got = lm_head_loss(w, x, labels)
    parts = [lm_head_loss(w, x[:, c:c + 512], labels[:, c:c + 512],
                          chunk=512) * (2 * 512) for c in (0, 512)]
    want = (torch.zeros(()) + parts[0] + parts[1]) / (2 * 1024)
    assert torch.equal(got, want)
    whole = lm_head_loss(w, x, labels, chunk=1024)
    torch.testing.assert_close(got, whole, rtol=1e-6, atol=0)


# one SMOKE config a family; jamba's groups hold 8 slots, the VLM's 5, and
# llama's FULL-every-2 variant 2
FAMILIES = {
    "dense": ("qwen3-0.6b", {}),
    "dense_groups_of_2": ("llama3.2-1b", dict(
        attn_kind="chunked", chunk=12, full_attn_every=2, num_layers=4)),
    "moe": ("mixtral-8x7b", {}),
    "rwkv6": ("rwkv6-7b", {}),
    "hybrid": ("jamba-1.5-large-398b", {}),
    "vlm": ("llama-3.2-vision-11b", {}),
}


def _config(family):
    arch, repl = FAMILIES[family]
    return dataclasses.replace(configs.get_smoke_config(arch), **repl)


def _draw_open(model, seed):
    """Mamba's conv and the VLM's cross gate start at 0, which shuts those
    blocks: draw them, as trained weights would hold."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("conv_w", "conv_b", "cross.gate")):
                p.copy_(torch.randn(p.shape, generator=g) * 0.3)


def _loss_and_grad(cfg, remat, ids, labels, vision):
    model = Model(cfg, device="cpu", seed=1, remat=remat)
    _draw_open(model, 2)
    grad = torch.zeros(model.d, dtype=model.flat.dtype)
    model.attach_grads(grad)
    loss = model.loss(ids, labels, vision)
    loss.backward()
    return loss.detach(), grad


@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_gradients_are_bit_equal(family):
    cfg = _config(family)
    g = torch.Generator().manual_seed(3)
    ids = torch.randint(0, cfg.vocab_size, (2, 64), generator=g)
    labels = torch.randint(0, cfg.vocab_size, (2, 64), generator=g)
    vision = (torch.randn((2, 7, cfg.d_model), generator=g)
              if cfg.cross_attn_every else None)
    if family.startswith(("hybrid", "vlm", "dense_groups")):
        assert cfg.group_size > 1
    loss0, grad0 = _loss_and_grad(cfg, "none", ids, labels, vision)
    assert torch.isfinite(grad0).all() and grad0.abs().max() > 0
    for remat in REMAT_MODES[:-1]:
        loss, grad = _loss_and_grad(cfg, remat, ids, labels, vision)
        assert torch.equal(loss, loss0), remat
        assert torch.equal(grad, grad0), remat


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_prefill_and_decode_do_not_depend_on_remat(family):
    cfg = _config(family)
    g = torch.Generator().manual_seed(4)
    ids = torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
    out = {}
    for remat in REMAT_MODES:
        model = Model(cfg, device="cpu", seed=1, remat=remat)
        _draw_open(model, 2)
        logits, caches = model.prefill(ids, max_len=20)
        pos = torch.full((2,), 16)
        step, _ = model.decode(ids[:, -1], pos, caches)
        out[remat] = (logits, step)
    for remat in REMAT_MODES[:-1]:
        for a, b in zip(out[remat], out["none"]):
            assert torch.equal(a, b), remat


def test_unknown_remat_is_refused():
    with pytest.raises(ValueError, match="remat"):
        Model(configs.get_smoke_config("qwen3-0.6b"), device="cpu",
              remat="some")

"""Serving in the port (``Model.prefill``/``decode``, ``repro_torch.serve``,
``launch/serve.py``) against the reference's, for the attention family:
the dense, sliding-window (8) and chunked (8) configs of
``test_decode_consistency.py``, and qk-norm with qkv bias.

Both sides get the same numpy weights (``test_torch_model._random_params``,
biases at unit scale) and the same tokens; the reference runs as its own
test runs it, ``shard_map`` on a (1, 1) mesh with ``cache_shards=1``, its
prefill and decode each jitted once a config.  For each config:

  * the port's prefill logits and every cache leaf against the
    reference's ``Model.prefill``;
  * three decode steps started from the reference's own prefill caches
    (``from_jax_caches``), so that decode is held apart from prefill:
    the logits and every cache leaf after each step against the
    reference's ``Model.decode``, the tokens fed to both (teacher
    forcing, so that an argmax tie cannot send them apart);
  * the port's own prefill and decode against its full forward's
    last-position logits: a prompt of 24 and decode steps to position 26
    with ``max_len`` 32 (the sliding and chunked rings of 8 wrap), and a
    prompt of 5 whose decode steps to position 12 overwrite the sliding
    ring's slots.

Tolerances (float32): logits within 1e-5 of their largest entry, cache
leaves (K and V after RoPE) within 1e-6 of theirs; the consistency check
within 1e-5 of the largest logit (the reference's own test allows 3e-4 /
4e-3).  ``tests/test_torch_serve_recurrent.py`` covers RWKV6, the Mamba
hybrid with MoE and the VLM.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.models import Model as JModel
from repro.models import ModelConfig as JModelConfig
from repro.serve import engine as jengine
from repro_torch.launch import serve
from repro_torch.models.layers import lm_head_logits
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Model
from repro_torch.serve import ServeConfig, make_decode_step, make_prefill_step
from repro_torch.weights import from_jax_caches, from_jax_params
from test_torch_model import _random_params

# one thread: xdist workers that each take every core starve one another
torch.set_num_threads(1)

BASE = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
            d_ff=128, vocab_size=256, compute_dtype="float32")
CONFIGS = {
    "dense": dict(arch_type="dense"),
    "sliding": dict(arch_type="dense", attn_kind="sliding", window=8),
    "chunked": dict(arch_type="dense", attn_kind="chunked", chunk=8),
    "qknorm_bias": dict(arch_type="dense", qk_norm=True, qkv_bias=True),
}
B, S, N_DECODE, MAX_LEN = 2, 24, 3, 32
LOGIT_TOL, CACHE_TOL = 1e-5, 1e-6


def config_pair(name, fields):
    """(reference config, port config) with the same fields."""
    kw = dict(BASE, name=name, **fields)
    return JModelConfig(**kw), ModelConfig(**kw)


def close(got, want, tol, what):
    """max |got - want| within ``tol`` of want's largest entry."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err)


def close_caches(got, want, tol, what):
    assert len(got) == len(want), what
    for slot, (g, w) in enumerate(zip(got, want)):
        for i in range(2):
            close(g[i], w[i], tol, f"{what} slot {slot} leaf {i}")


def reference_run(jcfg, params, ids, vision, max_len, prompt, steps):
    """The reference's prefill of ``ids[:, :prompt]`` and ``steps``
    teacher-forced decode steps: [(logits, caches) after the prefill and
    after each step], as numpy."""
    m = JModel(jcfg, tp=1, dp=1)
    pspecs = m.param_specs()
    vspec = None if vision is None else P("data")
    cspec = jax.tree.map(lambda _: P(), jax.eval_shape(
        lambda: m.init_cache(ids.shape[0], max_len, 1)))
    with jax.set_mesh(jax.make_mesh((1, 1), ("data", "model"))):
        def smap(f, i, o):
            return jax.jit(jax.shard_map(f, in_specs=i, out_specs=o,
                                         check_vma=False))

        pf = smap(lambda p, i, v: m.prefill(p, i, v, max_len=max_len,
                                            cache_shards=1),
                  (pspecs, P("data"), vspec), (P("data"), cspec))
        df = smap(lambda p, t, pos, c, v: m.decode(p, t, pos, c, v,
                                                   cache_shards=1),
                  (pspecs, P("data"), P("data"), cspec, vspec),
                  (P("data"), cspec))
        logits, caches = pf(params, jnp.asarray(ids[:, :prompt]), vision)
        out = [(np.asarray(logits), jax.tree.map(np.asarray, caches))]
        for t in range(prompt, prompt + steps):
            logits, caches = df(params, jnp.asarray(ids[:, t]),
                                jnp.full((ids.shape[0],), t, jnp.int32),
                                caches, vision)
            out.append((np.asarray(logits), jax.tree.map(np.asarray, caches)))
    return out


@functools.cache
def case(name):
    """(port model, ids, vision, the reference's run) of one config of
    this file or of ``test_torch_serve_recurrent.py``."""
    from test_torch_serve_recurrent import CONFIGS as RECURRENT
    fields = CONFIGS[name] if name in CONFIGS else RECURRENT[name]
    jcfg, cfg = config_pair(name, fields)
    np_params = _random_params(jcfg)
    model = Model(cfg, device="cpu")
    model.load_flat(from_jax_params(np_params, cfg))
    rng = np.random.default_rng(1)
    ids = rng.integers(0, cfg.vocab_size, (B, S + N_DECODE)).astype(np.int32)
    vision = (rng.standard_normal((B, 8, cfg.d_model)).astype(np.float32)
              if cfg.cross_attn_every else None)
    ref = reference_run(jcfg, jax.tree.map(jnp.asarray, np_params), ids,
                        None if vision is None else jnp.asarray(vision),
                        MAX_LEN, S, N_DECODE)
    return (model, torch.from_numpy(ids).long(),
            None if vision is None else torch.from_numpy(vision), ref)


def check_prefill(name, cache_tol=CACHE_TOL):
    model, ids, vision, ref = case(name)
    logits, caches = model.prefill(ids[:, :S], vision, max_len=MAX_LEN)
    close(logits, ref[0][0], LOGIT_TOL, f"{name} prefill logits")
    close_caches(caches, ref[0][1], cache_tol, f"{name} prefill")


def check_decode(name, cache_tol=CACHE_TOL):
    model, ids, vision, ref = case(name)
    caches = from_jax_caches(ref[0][1], model.cfg)
    for i, t in enumerate(range(S, S + N_DECODE)):
        pos = torch.full((B,), t, dtype=torch.int32)
        logits, caches = model.decode(ids[:, t], pos, caches, vision)
        close(logits, ref[i + 1][0], LOGIT_TOL, f"{name} step {t} logits")
        close_caches(caches, ref[i + 1][1], cache_tol, f"{name} step {t}")


def full_logits(model, ids, vision):
    """The port's full forward: the last position's float32 logits."""
    with torch.no_grad():
        x, _ = model.forward(ids, vision)
        return lm_head_logits(model.lm_head.to(model.compute_dtype),
                              x[:, -1])


def check_consistency(model, ids, vision, prompt, last, max_len):
    """The port's prefill of ``ids[:, :prompt]`` and teacher-forced decode
    steps to position ``last`` against its full forward at every step."""
    logits, caches = model.prefill(ids[:, :prompt], vision, max_len=max_len)
    want = full_logits(model, ids[:, :prompt], vision)
    close(logits, want.numpy(), LOGIT_TOL, f"prefill of {prompt}")
    for t in range(prompt, last + 1):
        pos = torch.full((ids.shape[0],), t, dtype=torch.int32)
        logits, caches = model.decode(ids[:, t], pos, caches, vision)
        want = full_logits(model, ids[:, :t + 1], vision)
        close(logits, want.numpy(), LOGIT_TOL, f"decode at position {t}")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_matches_reference(name):
    check_prefill(name)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_from_reference_caches_matches_reference(name):
    check_decode(name)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_and_decode_match_full_forward(name):
    model, ids, vision, _ = case(name)
    check_consistency(model, ids, vision, S, S + N_DECODE - 1, MAX_LEN)


def test_decode_overwrites_the_sliding_ring():
    """A prompt of 5 under a window of 8: decode steps to position 12
    write slots 5, 6, 7, then 0-4 again over positions 0-4."""
    model, _, _, _ = case("sliding")
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(0, 256, (B, 13))).long()
    check_consistency(model, ids, None, 5, 12, MAX_LEN)


def test_cache_layout():
    """``init_cache`` gives prefill's shapes and the reference's: one
    (k, v) pair a slot, (num_groups, B, C, KV, hd), C the window or chunk
    where it limits a token's view, else max_len; by default in the
    compute dtype, as prefill's, else in the dtype asked for."""
    for name in CONFIGS:
        model, ids, _, ref = case(name)
        zero = model.init_cache(B, MAX_LEN)
        _, caches = model.prefill(ids[:, :S], max_len=MAX_LEN)
        for z, c, r in zip(zero, caches, ref[0][1]):
            assert [t.shape for t in z] == [t.shape for t in c] == [
                torch.Size(np.shape(t)) for t in r]
            assert [t.dtype for t in z] == [t.dtype for t in c]
            assert not any(t.any() for t in z)
        bf16 = model.init_cache(B, MAX_LEN, torch.bfloat16)
        assert bf16[0][0].dtype == torch.bfloat16


def test_serve_steps_match_reference_tokens():
    """``make_prefill_step`` and ``make_decode_step``: int32 argmax tokens
    of the model's logits, greedy or at a temperature (the same token, as
    in the reference); ``ServeConfig``'s fields and defaults are the
    reference's, bar its ``cache_dtype``, which no step reads."""
    want = dataclasses.asdict(jengine.ServeConfig())
    del want["cache_dtype"]
    assert dataclasses.asdict(ServeConfig()) == want
    model, ids, _, ref = case("dense")
    for scfg in (ServeConfig(max_len=MAX_LEN),
                 ServeConfig(max_len=MAX_LEN, greedy=False,
                             temperature=0.7)):
        tok, caches = make_prefill_step(model, scfg)(ids[:, :S])
        assert tok.dtype == torch.int32
        assert tok.tolist() == np.argmax(ref[0][0], -1).tolist()
        caches = from_jax_caches(ref[0][1], model.cfg)
        tok, caches = make_decode_step(model, scfg)(
            ids[:, S], torch.full((B,), S, dtype=torch.int32), caches)
        assert tok.tolist() == np.argmax(ref[1][0], -1).tolist()


def test_launcher_serves_on_the_cpu(capsys):
    """``python -m repro_torch.launch.serve --device cpu``: the reference's
    lines, and greedy tokens that the model's full forward picks too."""
    res = serve.run(serve.parse_args(["--device", "cpu", "--batch", "2",
                                      "--prompt-len", "8", "--gen", "5"]))
    out = capsys.readouterr().out
    assert "prefill(2x8)" in out and "decoded 4 steps" in out
    assert "seq[0]:" in out and "seq[1]:" in out
    assert res["config"].name == "llama3.2-smoke"
    tokens, prompt = res["tokens"], res["prompt"]
    assert tokens.shape == (2, 5)
    model = Model(res["config"], device="cpu", seed=serve.SEED)
    for i in range(5):
        seq = torch.cat([prompt, tokens[:, :i]], dim=1)
        want = full_logits(model, seq, None).argmax(-1)
        assert tokens[:, i].tolist() == want.tolist(), i


def test_launcher_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--gen", "2"])

"""The port's blockwise attention against the reference's ``_flash``.

Both get the same q, k, v (made with numpy) and block sizes small enough
for several query and kv blocks, so the causal bounds (``hi``), the
window's first block (``lo``), the masks on blocks that straddle either
limit, the running max and sum, the query-block rule (at most
``MAX_Q_BLOCKS`` blocks, grown until it divides S) and the single-kv-block
fallback are all crossed.  The gradients are those of <out, g> for a
random cotangent g.

Tolerances: output rtol 1e-5 (atol 1e-6 for outputs near 0); q, k and v
gradients within 1e-5 of their largest entry (float32 throughout, with
sums in another order).

The VLM's gated cross-attention (``cross_attn_forward``: no RoPE, no
mask, 16 image embeddings, a non-zero gate) against the reference's in
its (1, 1) mesh, with the same tolerances for the output and for the
gradients of x, the embeddings and every leaf; and in bfloat16 weights
against float32 embeddings, where both packages compute K and V in
float32 and return bfloat16 (held within 1e-2 of the largest output:
bfloat16 rounding of q and of the projections).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models.layers import TPCtx, make_dims
from repro_torch import configs
from repro_torch.models import attention

# one thread: xdist workers that each take every core starve one another
torch.set_num_threads(1)

# (S, q_block, kv_block, window): several q and kv blocks, q blocks
# wider and narrower than kv blocks, a window across block edges, the
# MAX_Q_BLOCKS floor (q_block 1 at S=64 -> 2), a q block grown to divide
# S (20 -> 24 at S=48) and a kv block that does not divide S (one block)
CASES = [
    (64, 16, 8, 0), (64, 16, 8, 20), (64, 8, 16, 0), (64, 8, 16, 11),
    (64, 1, 8, 0), (48, 20, 20, 0), (48, 20, 20, 9),
]


def _inputs(S, seed=0, B=2, H=4, hd=16):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
                  for _ in range(4))
    return q, k, v, g


def _reference(q, k, v, g, *, window, q_block, kv_block):
    def f(q, k, v):
        return jattn._flash(q, k, v, causal=True, window=window,
                            q_block=q_block, kv_block=kv_block)

    @jax.jit
    def run(q, k, v, g):
        out, vjp = jax.vjp(f, q, k, v)
        return out, vjp(g)

    out, grads = run(*map(jnp.asarray, (q, k, v, g)))
    return np.asarray(out), [np.asarray(x) for x in grads]


@pytest.mark.parametrize("S,q_block,kv_block,window", CASES)
def test_flash_matches_reference(S, q_block, kv_block, window):
    q, k, v, g = _inputs(S)
    want, want_grads = _reference(q, k, v, g, window=window, q_block=q_block,
                                  kv_block=kv_block)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = attention._flash(tq, tk, tv, causal=True, window=window,
                           q_block=q_block, kv_block=kv_block)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6)
    for name, t, w in zip("qkv", (tq, tk, tv), want_grads):
        err = np.abs(t.grad.numpy() - w).max()
        assert err <= 1e-5 * np.abs(w).max(), (name, err)


def test_window_and_blocks_change_what_is_seen():
    """The cases above differ from full causal attention where they
    should: a window hides keys, block sizes do not."""
    q, k, v, _ = _inputs(64)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    full = attention._flash(*t, causal=True, window=0, q_block=64,
                            kv_block=64)
    blocked = attention._flash(*t, causal=True, window=0, q_block=16,
                               kv_block=8)
    windowed = attention._flash(*t, causal=True, window=20, q_block=16,
                                kv_block=8)
    torch.testing.assert_close(blocked, full, rtol=1e-5, atol=1e-6)
    assert torch.equal(windowed[:, :20], blocked[:, :20])
    assert not torch.allclose(windowed[:, 20:], blocked[:, 20:])


def test_gqa_expansion_matches_the_reference_gather():
    """kv head j serves q heads j * ratio .. (j + 1) * ratio - 1."""
    rng = np.random.default_rng(3)
    k = rng.standard_normal((2, 5, 2, 4)).astype(np.float32)
    got = attention._expand_kv(torch.from_numpy(k), 8).numpy()
    np.testing.assert_array_equal(got, np.take(k, np.arange(8) // 4, axis=2))


def test_flash_without_mask_over_a_kv_extent_the_block_does_not_divide():
    """Cross-attention's call: causal=False, 32 queries over 17 keys (as
    1601 image tokens), kv_block 8 falls back to one block of 17."""
    q, _, _, g = _inputs(32, seed=4)
    rng = np.random.default_rng(5)
    k, v = (rng.standard_normal((2, 17, 4, 16)).astype(np.float32)
            for _ in range(2))

    def f(q, k, v):
        return jattn._flash(q, k, v, causal=False, window=0, q_block=8,
                            kv_block=8)

    @jax.jit
    def run(q, k, v, g):
        out, vjp = jax.vjp(f, q, k, v)
        return out, vjp(g)

    want, want_grads = run(*map(jnp.asarray, (q, k, v, g)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = attention._flash(tq, tk, tv, causal=False, window=0, q_block=8,
                           kv_block=8)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    for name, t, w in zip("qkv", (tq, tk, tv), want_grads):
        err = np.abs(t.grad.numpy() - np.asarray(w)).max()
        assert err <= 1e-5 * np.abs(np.asarray(w)).max(), (name, err)


def _cross_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    d, nq, nkv = (cfg.d_model, cfg.num_heads * cfg.head_dim_,
                  cfg.num_kv_heads * cfg.head_dim_)
    p = {"wq": rng.standard_normal((d, nq)) / np.sqrt(d),
         "wk": rng.standard_normal((d, nkv)) / np.sqrt(d),
         "wv": rng.standard_normal((d, nkv)) / np.sqrt(d),
         "wo": rng.standard_normal((nq, d)) / np.sqrt(nq),
         "gate": np.array([0.7])}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 32, d)).astype(np.float32)
    vision = rng.standard_normal((2, 16, d)).astype(np.float32)
    dy = rng.standard_normal((2, 32, d)).astype(np.float32)
    return p, x, vision, dy


def _reference_cross(jcfg, p, x, vision, dy, dtype):
    ctx = TPCtx(tp=1, dp=1, compute_dtype=dtype)
    dims = make_dims(jcfg, 1)

    def f(p, x, vision, dy):
        def obj(p, x, vision):
            y = jattn.cross_attn_forward(ctx, jcfg, dims, p, x, vision)
            return jnp.sum(y.astype(jnp.float32) * dy), y

        (_, y), grads = jax.value_and_grad(obj, argnums=(0, 1, 2),
                                           has_aux=True)(p, x, vision)
        return y, grads

    args = jax.tree.map(jnp.asarray, (p, x, vision, dy))
    p, x = jax.tree.map(lambda a: a.astype(dtype), (args[0], args[1]))
    specs = jax.tree.map(lambda _: P(), args)
    with jax.set_mesh(jax.make_mesh((1, 1), ("data", "model"))):
        fn = jax.jit(jax.shard_map(f, in_specs=specs, out_specs=P(),
                                   check_vma=False))
        return fn(p, x, args[2], args[3])


def test_cross_attention_matches_reference():
    jcfg = jconfigs.get_smoke_config("llama-3.2-vision-11b")
    cfg = configs.get_smoke_config("llama-3.2-vision-11b")
    p, x, vision, dy = _cross_inputs(cfg, seed=6)
    want, (jgp, jgx, jgv) = jax.tree.map(
        np.asarray, _reference_cross(jcfg, p, x, vision, dy, jnp.float32))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx, tv = (torch.from_numpy(a).requires_grad_() for a in (x, vision))
    y = attention.cross_attn_forward(cfg, tp, tx, tv)
    (y * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6)
    assert np.abs(want).max() > 0.1   # the gate lets the block through
    for name, got, w in [("x", tx.grad, jgx), ("vision", tv.grad, jgv)] + [
            (k, tp[k].grad, jgp[k]) for k in tp]:
        err = np.abs(got.numpy() - w).max()
        assert err <= 1e-5 * np.abs(w).max(), (name, err)


def test_cross_attention_promotes_like_the_reference():
    """bf16 weights and x, float32 embeddings: K and V in float32, the
    output in bf16, on both sides."""
    jcfg = jconfigs.get_smoke_config("llama-3.2-vision-11b")
    cfg = configs.get_smoke_config("llama-3.2-vision-11b")
    p, x, vision, dy = _cross_inputs(cfg, seed=7)
    want, _ = _reference_cross(jcfg, p, x, vision, dy, jnp.bfloat16)
    assert want.dtype == jnp.bfloat16
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p.items()}
    y = attention.cross_attn_forward(
        cfg, tp, torch.from_numpy(x).to(torch.bfloat16),
        torch.from_numpy(vision))
    assert y.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    err = np.abs(y.float().numpy() - want).max()
    assert err <= 1e-2 * np.abs(want).max(), err

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
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
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

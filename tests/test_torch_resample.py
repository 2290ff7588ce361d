"""``resample_levels`` against the reference package.

The mixed-width codec quantizes each width group on the base grid
resampled to 2**bits levels, so a resampled grid one ulp off would move
codes at ties: grids are held bit-exact.  The reference evaluates its
``jnp.linspace`` positions at every (levels, num_out) pair in 2..256 x
2..256 (one compiled program per num_out, called with a scalar stop as
the reference calls it), and whole grids at the power-of-two pairs the
codec uses and at random pairs (random sorted grids, and ALQ's initial
grid).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codec as jcodec
from repro.core.schemes import QuantScheme as JScheme
from repro_torch.core import codec

# one thread: xdist workers that each take every core starve one another
torch.set_num_threads(1)


def _grid(L, seed):
    g = np.sort(np.random.default_rng(seed).random(L).astype(np.float32))
    g[0], g[-1] = 0.0, 1.0
    return g


def test_resample_positions_equal_the_references_at_every_pair():
    """The reference computes ``jnp.linspace(0.0, float(L - 1), num_out)``
    with a scalar stop; one compiled program per num_out."""
    for n in range(2, 257):
        lin = jax.jit(lambda s, n=n: jnp.linspace(0.0, s, n,
                                                  dtype=jnp.float32))
        for L in range(2, 257):
            want = np.asarray(lin(float(L - 1)))
            got = codec._resample_positions(L, n)
            assert got.dtype == np.float32
            assert np.array_equal(got.view(np.int32), want.view(np.int32)), \
                (L, n)


@pytest.mark.parametrize("L,n", [(2 ** a, 2 ** b) for a in (1, 3, 8)
                                 for b in range(1, 9)]
                         + [(5, 200), (77, 3), (256, 129), (131, 256)])
def test_resample_levels_match_reference(L, n):
    grids = np.stack([_grid(L, s) for s in range(4)])
    if L == 8:
        grids[0] = np.asarray(JScheme(name="alq", bits=3).init_levels())
    want = np.asarray(jax.jit(jax.vmap(
        lambda g: jcodec.resample_levels(g, n)))(jnp.asarray(grids)))
    got = np.stack([codec.resample_levels(torch.from_numpy(g), n).numpy()
                    for g in grids])
    assert np.array_equal(got.view(np.int32), want.view(np.int32))

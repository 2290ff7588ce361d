"""The port's adaptive-level path against the reference: level grids,
sufficient statistics merged over M workers, and one level update for
every adaptive scheme.

Both sides see the same worker gradients (numpy, from a seed).  The
reference runs ``gather_stats`` under ``jax.vmap`` with a named worker
axis, which is how it merges statistics across workers.  Tolerances:
stats rtol 1e-5 (sums in another order); levels atol 1e-5, except for
ALQ's coordinate descent (alq, alq_n, alq_inf): its float32 bisections
sit where the mixture's density is small, so last-ulp differences in
the statistics or in erf move the reference's own levels by 1-2e-5,
and the reference differs from a float64 solution by ~5e-5.  Those
levels are held at atol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import levels as jlevels
from repro.core.schemes import ADAPTIVE_SCHEMES
from repro.core.schemes import QuantScheme as JScheme
from repro.core.schemes import default_update_schedule as jschedule
from repro.dist import sync as jsync
from repro_torch.core import levels
from repro_torch.core.schemes import QuantScheme, default_update_schedule
from repro_torch.dist import sync

# one thread: xdist workers that each take every core starve one another
torch.set_num_threads(1)


@pytest.mark.parametrize("bits", range(1, 9))
def test_level_grids_match_bit_for_bit(bits):
    for got, want in [
            (levels.uniform_levels(bits, device="cpu"),
             jlevels.uniform_levels(bits)),
            (levels.exp_levels(bits, 0.5, device="cpu"),
             jlevels.exp_levels(bits, 0.5))]:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    p = torch.tensor(0.37)
    np.testing.assert_allclose(
        levels.multiplier_to_levels(p, bits).numpy(),
        np.asarray(jlevels.multiplier_to_levels(jnp.float32(0.37), bits)),
        rtol=1e-6)


def test_update_schedule_matches():
    for total in (50, 150, 5000, 35_000):
        assert default_update_schedule(total) == jschedule(total)


def _grads(M, d, seed):
    rng = np.random.default_rng(seed)
    # heavy-tailed, per-worker scaled gradients: nontrivial mixtures
    g = rng.standard_t(4, size=(M, d)) * np.exp(rng.standard_normal((M, 1)))
    return (g * 1e-3).astype(np.float32)


def _reference_stats(jscheme, grads):
    def worker(g):
        return jsync.gather_stats(g, jscheme, axes=("w",), use_pallas=False)

    stats = jax.jit(jax.vmap(worker, axis_name="w"))(jnp.asarray(grads))
    return jax.tree.map(lambda a: a[0], stats)  # replicated on every worker


@pytest.mark.parametrize("name", ADAPTIVE_SCHEMES)
def test_one_level_update_matches_reference(name):
    M, d, bs = 3, 40 * 256 + 100, 256
    jscheme = JScheme(name=name, bits=3, bucket_size=bs,
                      max_stat_components=16)
    scheme = QuantScheme(name=name, bits=3, bucket_size=bs,
                         max_stat_components=16)
    grads = _grads(M, d, seed=len(name))
    jstats = _reference_stats(jscheme, grads)
    stats = sync.gather_stats(torch.from_numpy(grads), scheme)
    for a, b in zip(stats, jstats):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)

    jnew = jscheme.update_state(jscheme.init_state(), jstats)
    new = scheme.update_state(scheme.init_state("cpu"), stats)
    assert new.num_updates == 1
    cd = jscheme._base in ("alq", "alq_n")
    np.testing.assert_allclose(new.levels.numpy(), np.asarray(jnew.levels),
                               atol=1e-4 if cd else 1e-5)
    # the entropy follows the levels: relative 1e-4
    np.testing.assert_allclose(float(new.entropy_bits),
                               float(jnew.entropy_bits), rtol=1e-4)
    assert not np.allclose(new.levels.numpy(),
                           scheme.init_levels("cpu").numpy())


def test_fixed_schemes_do_not_adapt():
    scheme = QuantScheme(name="qsgdinf", bits=3, bucket_size=256)
    state = scheme.init_state("cpu")
    grads = torch.from_numpy(_grads(2, 1000, seed=0))
    assert sync.maybe_update_levels(grads, scheme, state, True) is state


def test_mixture_functions_match_reference():
    from repro.core import coding as jcoding
    from repro.core import stats as jstats
    from repro_torch.core import coding, stats
    rng = np.random.default_rng(7)
    K = 12
    raw = (rng.random(K) * 0.3, rng.random(K) * 0.2 + 1e-3,
           rng.random(K) + 0.1)
    raw = tuple(x.astype(np.float32) for x in raw)
    raw = raw[:2] + ((raw[2] / raw[2].sum()).astype(np.float32),)
    js = jstats.TruncNormStats(*(jnp.asarray(x) for x in raw))
    ts = stats.TruncNormStats(*(torch.from_numpy(x) for x in raw))
    x = np.linspace(-0.1, 1.1, 25, dtype=np.float32)
    a, c = x[:-1], x[1:]
    # one compiled program per function instead of one per operation
    for name in ("mixture_pdf", "mixture_cdf"):
        np.testing.assert_allclose(
            getattr(stats, name)(ts, torch.from_numpy(x)).numpy(),
            np.asarray(jax.jit(getattr(jstats, name))(js, jnp.asarray(x))),
            rtol=1e-5, atol=1e-6)
    for name in ("partial_moment0", "partial_moment1", "partial_moment2"):
        np.testing.assert_allclose(
            getattr(stats, name)(ts, torch.from_numpy(a),
                                 torch.from_numpy(c)).numpy(),
            np.asarray(jax.jit(getattr(jstats, name))(js, jnp.asarray(a),
                                                      jnp.asarray(c))),
            rtol=1e-5, atol=1e-6)
    lv = np.array(jlevels.exp_levels(3, 0.5))
    np.testing.assert_allclose(
        float(stats.expected_variance(ts, torch.from_numpy(lv))),
        float(jax.jit(jstats.expected_variance)(js, jnp.asarray(lv))),
        rtol=1e-5)
    probs = coding.level_probabilities(torch.from_numpy(lv), ts)
    jprobs = jax.jit(jcoding.level_probabilities)(jnp.asarray(lv), js)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(coding.entropy_bits(probs)),
                               float(jcoding.entropy_bits(jprobs)), rtol=1e-5)


def test_level_helpers_match_reference():
    for bits in (1, 2, 3):
        assert levels.num_inner(bits) == jlevels.num_inner(bits)
    lv = levels.exp_levels(3, 0.5, device="cpu")
    jlv = jlevels.exp_levels(3, 0.5)
    np.testing.assert_array_equal(levels.level_gaps(lv).numpy(),
                                  np.asarray(jlevels.level_gaps(jlv)))
    assert bool(levels.is_feasible(lv)) == bool(jlevels.is_feasible(jlv))
    bad = lv.flip(0)
    assert not bool(levels.is_feasible(bad))
    assert bool(jlevels.is_feasible(jnp.asarray(bad.numpy()))) is False


def test_bucketing_matches_reference():
    import importlib
    # both packages' core re-exports a function named ``quantize``
    jq = importlib.import_module("repro.core.quantize")
    tq = importlib.import_module("repro_torch.core.quantize")
    rng = np.random.default_rng(3)
    v = rng.standard_normal(1000).astype(np.float32)
    vb = tq.pad_to_buckets(torch.from_numpy(v), 128)
    jvb = jq.pad_to_buckets(jnp.asarray(v), 128)
    np.testing.assert_array_equal(vb.numpy(), np.asarray(jvb))
    for norm in ("l2", "linf", "l1"):
        np.testing.assert_allclose(tq.bucket_norm(vb, norm).numpy(),
                                   np.asarray(jq.bucket_norm(jvb, norm)),
                                   rtol=1e-6)
    for L in (2, 128, 129, 256):
        assert tq.code_dtype(L) == getattr(torch, jq.code_dtype(L).__name__)

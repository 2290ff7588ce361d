"""The rest of ``repro.core``'s public API in the port, against the
reference on the same inputs.

Gradients, statistics and levels are made with numpy; the uniforms of
the stochastic rounding are the ones the reference's ``encode`` draws
(``jax.random.uniform(key, (nb, bucket_size))``), passed to the port.

Tolerances, as in ``test_torch_kernels.py``: codes equal except where
the reference's |u - rho| < 1e-5 (a norm summed in another order moves
rho in its last ulp), norms rtol 1e-6, ``quantization_variance`` and
the fitted statistics rtol 1e-5, the inverse CDFs atol 1e-5;
``amq_objective`` within 1e-5 of the magnitude of its terms (its float32
closed form cancels; see the test).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro_torch.kernels import cuda, ref

# one thread: xdist workers that each take every core starve one another
torch.set_num_threads(1)

BS = 256


def _grad(d=3000, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(d) * np.exp(rng.standard_normal(d))
            ).astype(np.float32)


def _levels(bits):
    return np.asarray(J.exp_levels(bits, 0.6) if bits == 4
                      else J.uniform_levels(bits))


def _uniforms(key, d):
    nb = -(-d // BS)
    return np.array(jax.random.uniform(key, (nb, BS), dtype=jnp.float32))


def _assert_codes(got, want, v, u, norms, levels):
    """Codes equal, or off by one where the reference's |u - rho| < 1e-5."""
    t = (torch.from_numpy(x) for x in (got, want, v, u, norms, levels))
    got, want, v, u, norms, levels = t
    vb = T.pad_to_buckets(v, BS)
    ref.code_mismatches(got, want, vb, u, norms, levels)


@pytest.mark.parametrize("bits,norm", [(3, "l2"), (4, "l2"), (2, "linf"),
                                       (8, "l1"), (8, "linf")])
def test_encode_decode_quantize_match_reference(bits, norm):
    v, levels = _grad(seed=bits), _levels(bits)
    key = jax.random.PRNGKey(bits)
    jenc = jax.jit(lambda v, lv, k: J.encode(v, lv, k, bucket_size=BS,
                                             norm_type=norm))
    jqt = jenc(jnp.asarray(v), jnp.asarray(levels), key)
    want_codes, want_norms = np.array(jqt.codes), np.array(jqt.norms)
    u = _uniforms(key, v.size)

    cuda.reset_launches()
    tv, tl, tu = map(torch.from_numpy, (v, levels, u))
    qt = T.encode(tv, tl, tu, bucket_size=BS, norm_type=norm)
    assert sum(cuda.LAUNCHES.values()) == 0  # the plain versions on the CPU
    assert qt.dim == v.size and qt.codes.dtype == T.code_dtype(levels.size)
    assert str(qt.codes.dtype)[6:] == str(want_codes.dtype)
    np.testing.assert_allclose(qt.norms.numpy(), want_norms, rtol=1e-6)
    _assert_codes(qt.codes.numpy(), want_codes, v, u, want_norms, levels)

    # decode is exact given the codes and norms
    got = T.decode(qt._replace(codes=torch.from_numpy(want_codes),
                               norms=torch.from_numpy(want_norms)), tl)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(J.decode(jqt, jnp.asarray(levels))))
    qv = T.quantize(tv.reshape(60, 50), tl, tu, bucket_size=BS,
                    norm_type=norm)
    assert qv.shape == (60, 50)
    np.testing.assert_array_equal(qv.reshape(-1).numpy(),
                                  T.decode(qt, tl).numpy())

    jvar = J.quantization_variance(jnp.asarray(v), jnp.asarray(levels),
                                   bucket_size=BS, norm_type=norm)
    var = T.quantization_variance(tv, tl, bucket_size=BS, norm_type=norm)
    np.testing.assert_allclose(var.item(), float(jvar), rtol=1e-5)


@pytest.mark.parametrize("norm", ["l2", "linf", "l1"])
def test_normalized_magnitudes_and_stochastic_round(norm):
    v, levels = _grad(seed=7), _levels(3)
    jr, jn = J.normalized_magnitudes(jnp.asarray(v), BS, norm)
    r, n = T.normalized_magnitudes(torch.from_numpy(v), BS, norm)
    np.testing.assert_allclose(n.numpy(), np.asarray(jn), rtol=1e-6)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-6,
                               atol=1e-7)
    u = _uniforms(jax.random.PRNGKey(7), v.size)
    want = np.asarray(J.stochastic_round(jr, jnp.asarray(levels),
                                         jnp.asarray(u)))
    got = T.stochastic_round(r, torch.from_numpy(levels), torch.from_numpy(u))
    assert got.dtype == torch.int32
    # the signed codes' tie rule, on magnitudes of one sign
    _assert_codes(got.numpy(), want, np.abs(v), u, np.asarray(jn), levels)


def test_clip_coordinates():
    from repro.core.quantize import clip_coordinates as jclip
    from repro_torch.core.quantize import clip_coordinates
    v = _grad(seed=3).reshape(30, 100)
    want = np.asarray(jclip(jnp.asarray(v), 2.5))
    got = clip_coordinates(torch.from_numpy(v), 2.5)
    assert got.shape == v.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert np.any(np.abs(want) < np.abs(v))  # something was clipped


def _mixture(seed=0, n=40):
    rng = np.random.default_rng(seed)
    mu = rng.uniform(0.0, 0.3, n).astype(np.float32)
    sigma = rng.uniform(0.02, 0.2, n).astype(np.float32)
    w = rng.uniform(0.1, 1.0, n).astype(np.float32)
    gamma = (w / w.sum()).astype(np.float32)
    return (J.TruncNormStats(*map(jnp.asarray, (mu, sigma, gamma))),
            T.TruncNormStats(*map(torch.from_numpy, (mu, sigma, gamma))))


@pytest.mark.parametrize("weighted,masked", [(True, False), (False, False),
                                             (True, True)])
def test_fit_bucket_stats(weighted, masked):
    v = _grad(d=70 * BS + 100, seed=11)
    jr, jn = J.normalized_magnitudes(jnp.asarray(v), BS, "l2")
    mask = None
    if masked:   # the padding of the last bucket
        mask = (np.arange(jr.size) < v.size).reshape(jr.shape).astype(
            np.float32)
    kw = dict(weighted=weighted, max_components=64)
    want = J.fit_bucket_stats(jr, jn, mask=None if mask is None
                              else jnp.asarray(mask), **kw)
    got = T.fit_bucket_stats(
        torch.from_numpy(np.asarray(jr)), torch.from_numpy(np.asarray(jn)),
        mask=None if mask is None else torch.from_numpy(mask), **kw)
    assert got.n_components == want.n_components == 64
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)


def test_inverse_cdfs():
    jst, tst = _mixture()
    y = np.linspace(0.01, 0.99, 41, dtype=np.float32)
    want = np.asarray(J.mixture_inverse_cdf(jst, jnp.asarray(y)))
    got = T.mixture_inverse_cdf(tst, torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(T.mixture_cdf(tst, got).numpy(), y, atol=1e-5)

    from repro.core.stats import single_trunc_norm_inverse_cdf as jsingle
    from repro_torch.core.stats import single_trunc_norm_inverse_cdf
    for mu, sigma in ((0.1, 0.05), (0.3, 0.2), (0.0, 0.5)):
        want = np.asarray(jsingle(mu, sigma, jnp.asarray(y)))
        got = single_trunc_norm_inverse_cdf(mu, sigma, torch.from_numpy(y))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
        # one component: the closed form and the bisection agree
        one = T.TruncNormStats(torch.tensor([mu]), torch.tensor([sigma]),
                               torch.tensor([1.0]))
        np.testing.assert_allclose(T.mixture_inverse_cdf(one, got.new_tensor(
            y)).numpy(), got.numpy(), atol=1e-5)


def _psi_terms(stats, levels):
    """The magnitude of Psi's terms, sum_j |m2| + |a+c| |m1| + |a c| m0
    over the level intervals [a, c], in float64."""
    stats = T.TruncNormStats(*(x.double() for x in stats))
    a, c = levels[:-1].double(), levels[1:].double()
    m0, m1, m2 = (f(stats, a, c) for f in (
        T.partial_moment0, T.partial_moment1, T.partial_moment2))
    return float(torch.sum(m2.abs() + (a + c).abs() * m1.abs()
                           + (a * c).abs() * m0.abs()))


@pytest.mark.parametrize("bits", [2, 3, 4])
def test_amq_objective(bits):
    """Psi's float32 closed form cancels to a small fraction of its terms
    (ROADMAP section 3), and the reference's own value is up to 1e-4 off
    a float64 evaluation here.  So each value is held within 1e-5 of the
    magnitude of its terms, and the port's value must stay as close to
    the float64 one as the reference's (or within 1e-5 relative)."""
    jst, tst = _mixture(seed=bits)
    jfn = jax.jit(J.amq_objective, static_argnums=2)
    for p in (0.2, 0.5, 0.8):
        want = float(jfn(jnp.float32(p), jst, bits))
        got = T.amq_objective(torch.tensor(p), tst, bits).item()
        terms = _psi_terms(tst, T.multiplier_to_levels(torch.tensor(p), bits))
        assert abs(got - want) <= 1e-5 * terms, (p, got, want, terms)
        exact = T.amq_objective(torch.tensor(p, dtype=torch.float64),
                                T.TruncNormStats(*(x.double() for x in tst)),
                                bits).item()
        assert abs(got - exact) <= max(abs(want - exact), 1e-5 * exact)


def test_core_exports_the_reference_public_names():
    public = {n for n in dir(J) if not n.startswith("_")}
    submodules = {"adapt", "codec", "coding", "levels", "packing",
                  "quantize", "schemes", "stats", "annotations"}
    assert sorted(public - submodules - set(dir(T))) == []

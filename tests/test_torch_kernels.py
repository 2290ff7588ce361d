"""The port's kernel modules against the reference package.

The plain PyTorch versions (what ``repro_torch.kernels.ops`` runs for a
CPU tensor) are held against ``repro.kernels.ref`` over the shape sweep
of ``test_kernels.py`` plus an 8-bit (int16) grid, and against the Pallas
kernels in interpret mode on the first two shapes (interpret mode costs
about a second a case).  The CUDA kernels themselves are held against
the plain versions on the card in ``test_torch_cuda.py``.

Tolerances: norms rtol 1e-6 and stats rtol 1e-5 (sums taken in another
order); dequantized values exact (one rounding, same order); codes
exact, except that a code may differ by one where the reference's
``|u - rho| < 1e-5``, i.e. where a last-ulp norm difference moves rho
across u.
"""
import inspect
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import exp_levels, ternary_levels, uniform_levels
from repro.kernels import ref as jref
from repro.kernels.bucket_stats import bucket_stats_pallas
from repro.kernels.dequantize import dequantize_pallas
from repro.kernels.quantize import quantize_pallas
from repro_torch.core.quantize import code_dtype
from repro_torch.kernels import cuda as kcuda
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

# one thread: xdist workers that each take every core starve one another
torch.set_num_threads(1)

SHAPES = [(8, 256), (16, 512), (8, 1024), (32, 128), (24, 256)]
LEVELS = {
    "uniform3": lambda: uniform_levels(3),
    "exp4": lambda: exp_levels(4, 0.5),
    "ternary": ternary_levels,
    "uniform8": lambda: uniform_levels(8),
}
# test_kernels.py's sweep, plus the 8-bit (int16) edge on one shape
SWEEP = [(s, lv) for s in SHAPES for lv in ("uniform3", "exp4", "ternary")]
SWEEP.append((SHAPES[0], "uniform8"))
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
# one compiled program per shape instead of one per operation
_jquantize = jax.jit(jref.quantize_ref, static_argnums=3)
_jdequantize = jax.jit(jref.dequantize_ref)
_jbucket_stats = jax.jit(jref.bucket_stats_ref, static_argnums=1)
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _values(nb, bs, dt, seed=0):
    """The same (bf16-rounded, for bf16) values for both sides: the
    reference gets them as float32, which is what its plain versions
    convert a bf16 input to first; the port gets them in ``dt``."""
    rng = np.random.default_rng([seed, nb, bs])
    v = (rng.standard_normal((nb, bs)) * 0.1).astype(np.float32)
    vj = jnp.asarray(v).astype(JDT[dt]).astype(jnp.float32)
    vt = torch.from_numpy(np.array(vj)).to(TDT[dt])
    u = rng.random((nb, bs), dtype=np.float32)
    return vj, vt, u


def assert_codes_match(got, want, v, u, norms, levels):
    """Codes equal except the ties ``ref.code_mismatches`` allows, judged
    under the reference's norms."""
    tref.code_mismatches(torch.from_numpy(np.asarray(got, np.int32)),
                         torch.from_numpy(np.asarray(want, np.int32)),
                         torch.from_numpy(np.array(v, np.float32)),
                         torch.from_numpy(np.array(u, np.float32)),
                         torch.from_numpy(np.array(norms, np.float32)),
                         torch.from_numpy(np.array(levels, np.float32)))


def _quantize_case(nb, bs, lname, norm, dt):
    levels = LEVELS[lname]()
    vj, vt, u = _values(nb, bs, dt)
    c2, n2 = tref.quantize_ref(vt, torch.from_numpy(u),
                               torch.from_numpy(np.array(levels)), norm)
    assert c2.dtype == code_dtype(levels.shape[0])
    return levels, vj, u, c2.numpy(), n2.numpy()


@pytest.mark.parametrize("shape,lname", SWEEP)
@pytest.mark.parametrize("norm", ["l2", "linf"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_quantize_plain_matches_reference(shape, lname, norm, dt):
    nb, bs = shape
    levels, vj, u, c2, n2 = _quantize_case(nb, bs, lname, norm, dt)
    c1, n1 = _jquantize(vj, jnp.asarray(u), levels, norm)
    np.testing.assert_allclose(n2, np.asarray(n1), rtol=1e-6)
    assert_codes_match(c2, c1, vj, u, n1, levels)


@pytest.mark.parametrize("nb,bs", SHAPES[:2])
@pytest.mark.parametrize("lname", ["uniform3", "exp4", "ternary"])
@pytest.mark.parametrize("norm", ["l2", "linf"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_quantize_plain_matches_pallas(nb, bs, lname, norm, dt):
    levels, vj, u, c2, n2 = _quantize_case(nb, bs, lname, norm, dt)
    c1, n1 = quantize_pallas(vj, jnp.asarray(u), levels,
                             norm_type=norm, interpret=True)
    np.testing.assert_allclose(n2, np.asarray(n1), rtol=1e-6)
    assert_codes_match(c2, c1, vj, u, n1, levels)


def _codes(nb, bs, levels, dtype):
    rng = np.random.default_rng([1, nb, bs])
    L = levels.shape[0]
    codes = rng.integers(-(L - 1), L, size=(nb, bs)).astype(dtype)
    norms = (rng.random(nb) + 0.1).astype(np.float32)
    return codes, norms


@pytest.mark.parametrize("shape,lname", SWEEP)
@pytest.mark.parametrize("cdt", ["narrow", "int32"])
def test_dequantize_plain_matches_reference(shape, lname, cdt):
    """int32 codes come from the decode path, narrow ones from encode."""
    nb, bs = shape
    levels = LEVELS[lname]()
    narrow = np.int8 if levels.shape[0] <= 128 else np.int16
    codes, norms = _codes(nb, bs, levels,
                          narrow if cdt == "narrow" else np.int32)
    want = _jdequantize(jnp.asarray(codes), jnp.asarray(norms), levels)
    got = tref.dequantize_ref(torch.from_numpy(codes),
                              torch.from_numpy(norms),
                              torch.from_numpy(np.array(levels)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("nb,bs", SHAPES[:2])
@pytest.mark.parametrize("lname", list(LEVELS))
def test_dequantize_plain_matches_pallas(nb, bs, lname):
    levels = LEVELS[lname]()
    codes, norms = _codes(nb, bs, levels, np.int32)
    want = dequantize_pallas(jnp.asarray(codes), jnp.asarray(norms), levels,
                             interpret=True)
    got = tref.dequantize_ref(torch.from_numpy(codes),
                              torch.from_numpy(norms),
                              torch.from_numpy(np.array(levels)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dequantize_outside_the_table_gives_zero_like_pallas():
    """A corrupt symbol can unbias to |c| >= L (at 3 bits a symbol has 4
    bits, so c reaches L); the one-hot lookup of the TPU kernel gives 0."""
    levels = LEVELS["uniform3"]()
    L = levels.shape[0]
    rng = np.random.default_rng(2)
    codes = rng.integers(-(L + 7), L + 8, size=(8, 256)).astype(np.int32)
    norms = (rng.random(8) + 0.1).astype(np.float32)
    want = dequantize_pallas(jnp.asarray(codes), jnp.asarray(norms), levels,
                             interpret=True)
    got = tref.dequantize_ref(torch.from_numpy(codes),
                              torch.from_numpy(norms),
                              torch.from_numpy(np.array(levels)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got.numpy()[np.abs(codes) >= L].any()


@pytest.mark.parametrize("nb,bs", SHAPES)
@pytest.mark.parametrize("norm", ["l2", "linf"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_bucket_stats_plain_matches_reference(nb, bs, norm, dt):
    vj, vt, _ = _values(nb, bs, dt, seed=3)
    want = _jbucket_stats(vj, norm)
    got = tref.bucket_stats_ref(vt, norm)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("nb,bs", SHAPES[:2])
@pytest.mark.parametrize("norm", ["l2", "linf"])
def test_bucket_stats_plain_matches_pallas(nb, bs, norm):
    vj, vt, _ = _values(nb, bs, "f32", seed=3)
    want = bucket_stats_pallas(vj, norm_type=norm, interpret=True)
    got = tref.bucket_stats_ref(vt, norm)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)


def test_ops_take_the_plain_version_for_cpu_tensors_only():
    _, vt, u = _values(8, 256, "f32")
    lv = torch.from_numpy(np.array(uniform_levels(3)))
    before = dict(kcuda.LAUNCHES)
    codes, norms = ops.quantize_op(vt, torch.from_numpy(u), lv)
    ops.dequantize_op(codes, norms, lv)
    ops.bucket_stats_op(vt)
    assert dict(kcuda.LAUNCHES) == before  # CPU calls launch nothing
    # a meta tensor takes the kernel's operator, whose fake gives the
    # outputs' shapes and dtypes and launches nothing; a CUDA tensor
    # goes to the launch functions themselves, never through an operator
    assert all(inspect.isfunction(f) for f in (
        ops.quantize_cuda, ops.dequantize_cuda, ops.bucket_stats_cuda))
    meta = torch.empty((8, 256), device="meta")
    codes, norms = ops.quantize_op(meta, meta, lv.to("meta"))
    assert (codes.device.type, codes.shape, codes.dtype, norms.shape) == (
        "meta", (8, 256), torch.int8, (8,))
    assert ops.dequantize_op(codes, norms, lv.to("meta")).dtype == (
        torch.float32)
    assert [t.shape for t in ops.bucket_stats_op(meta)] == [(8,)] * 3
    assert dict(kcuda.LAUNCHES) == before
    with pytest.raises(ValueError, match="no kernel for device"):
        ops._route(types.SimpleNamespace(device=torch.device("xpu")),
                   "quantize")

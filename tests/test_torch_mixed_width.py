"""The port's mixed-width wire (``MixedWidthCodec``, ``assign_mixed_widths``)
against the reference package (``resample_levels`` is held in
``test_torch_resample.py``).

Both packages get the same gradients (numpy, from a seed) and the same
uniforms (the reference's ``jax.random`` draws); each reference call is
jitted once per shape.

Tolerances (ROADMAP, "How each slice is held"):
  * segment layouts, plans and widths exact; symbol words exact; norms at
    rtol 1e-6 (sums in another order); the port's decode of the
    reference's words exact (diagonal, and each segment on its own);
  * ``requantize`` within 1e-6 of each bucket's norm (the norm may differ
    in the last ulp), or one level step off where a rounding tie moved;
  * width assignments exact.  The greedy allocation compares float64
    copies of float32 error estimates whose last ulps differ between the
    packages, so two gains tied to the last ulp could be popped in another
    order; the random statistics below have no such near-tie;
  * sync: bits/coord exact, the aggregate under the tie rule of
    ``test_torch_two_phase.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_two_phase import assert_tie_rule

from repro.core import codec as jcodec
from repro.core.schemes import QuantScheme as JScheme
from repro.dist import sync as jsync
from repro_torch.core import codec
from repro_torch.core.packing import unpack_norms
from repro_torch.core.schemes import QuantScheme
from repro_torch.dist import sync

# one thread: xdist workers that each take every core starve one another
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(13)


def _grads(M, d, seed=0):
    rng = np.random.default_rng(seed)
    scale = np.exp(rng.standard_normal((M, 1)))
    return (rng.standard_normal((M, d)) * 1e-2 * scale).astype(np.float32)


def _uniforms(key, shape):
    return torch.from_numpy(np.array(
        jax.random.uniform(key, shape, jnp.float32)))


def _as_port(payload):
    return type(payload)(*(torch.from_numpy(np.array(x).view(np.int32))
                           for x in payload))


def _pair(widths=(), bits=3, bs=128, norm_dtype="float32", name="alq"):
    kw = dict(name=name, bits=bits, bucket_size=bs, norm_dtype=norm_dtype)
    return (JScheme(**kw), QuantScheme(**kw),
            jcodec.make_codec(JScheme(**kw), "mixed_width", widths),
            codec.make_codec(QuantScheme(**kw), "mixed_width", widths))


@pytest.mark.parametrize("widths,shards", [
    ((2, 4), 1), ((2, 4), 4), ((1, 8, 3), 4), ((3,), 2),
    (tuple(np.random.default_rng(0).integers(1, 9, 40).tolist()), 4)])
def test_layouts_and_plans_match_reference(widths, shards):
    _, _, jc, tc = _pair(widths)
    for d in (128 * 37 + 5, 128 * 40):
        jplan, plan = jc.plan(d, shards=shards), tc.plan(d, shards=shards)
        for f in plan._fields:
            assert getattr(plan, f) == getattr(jplan, f), f
        assert codec._segment_layouts(plan.widths, shards, 128) == \
            jcodec._segment_layouts(jplan.widths, shards, 128)
    assert tc.nominal_bits_per_coord == pytest.approx(
        jc.nominal_bits_per_coord, rel=1e-12)
    assert tc.mean_scheme_bits == jc.mean_scheme_bits
    assert not tc.chunkable and not jc.chunkable


@pytest.mark.parametrize("widths,shards,norm_dtype", [
    ((2, 4), 1, "float32"), ((2, 4), 4, "float32"),
    ((1, 8, 3), 4, "float16"), ((5, 7, 8, 1), 2, "float32"),
    ((6, 2, 3), 3, "float32")])
def test_words_and_decode_match_reference(widths, shards, norm_dtype):
    jscheme, scheme, jc, tc = _pair(widths, norm_dtype=norm_dtype)
    d = 128 * 45 + 5
    jplan, plan = jc.plan(d, shards=shards), tc.plan(d, shards=shards)
    levels = jscheme.init_levels()
    tlevels = scheme.init_levels("cpu")
    flat = _grads(1, d, seed=len(widths) + shards)[0]

    @jax.jit
    def reference(f):
        pay = jc.encode(jc.bucketize(f, jplan), levels, KEY, jplan,
                        use_pallas=False)
        return pay, jc.decode(pay, levels, jplan, use_pallas=False)

    jpay, jvals = reference(jnp.asarray(flat))
    tpay = tc.encode(tc.bucketize(torch.from_numpy(flat), plan), tlevels,
                     plan=plan, u=_uniforms(KEY, (plan.nb, 128)))
    np.testing.assert_array_equal(tpay.words.numpy(),
                                  np.asarray(jpay.words).view(np.int32))
    nw = tpay.norm_words.reshape(shards, -1)
    jnw = np.asarray(jpay.norm_words).reshape(shards, -1)
    for s in range(shards):
        np.testing.assert_allclose(
            unpack_norms(nw[s], plan.shard_nb, norm_dtype).numpy(),
            np.asarray(jcodec.packing.unpack_norms(jnw[s], plan.shard_nb,
                                                   norm_dtype)),
            rtol=1e-6 if norm_dtype == "float32" else 1e-3)
    as_port = _as_port(jpay)
    np.testing.assert_array_equal(tc.decode(as_port, tlevels, plan).numpy(),
                                  np.asarray(jvals))
    if shards > 1:
        # each segment on its own, as a rank decodes its shard; the
        # reference's diagonal decode is its per-segment decodes stacked
        for s in range(shards):
            got = tc.decode(type(as_port)(as_port.words[s][None],
                                          as_port.norm_words[s][None]),
                            tlevels, plan, shard=s)
            np.testing.assert_array_equal(got[0].numpy(),
                                          np.asarray(jvals)[s])
        with pytest.raises(ValueError, match="diagonal decode"):
            tc.decode(type(as_port)(as_port.words[:1], as_port.norm_words[:1]),
                      tlevels, plan)


@pytest.mark.parametrize("chunk", [0, 2])
def test_requantize_matches_reference(chunk):
    jscheme, scheme, jc, tc = _pair((1, 8, 3, 5))
    d = 128 * 32
    jplan, plan = jc.plan(d, shards=4), tc.plan(d, shards=4)
    vb = _grads(1, plan.shard_n, seed=chunk)[0].reshape(plan.shard_nb, 128)
    key = jax.random.fold_in(KEY, chunk)
    want = np.asarray(jax.jit(lambda v: jc.requantize(
        v, jscheme.init_levels(), key, jplan, chunk=chunk,
        use_pallas=False))(jnp.asarray(vb)))
    got = tc.requantize(torch.from_numpy(vb), scheme.init_levels("cpu"),
                        plan=plan, chunk=chunk,
                        u=_uniforms(key, vb.shape)).numpy()
    norm = np.repeat(np.linalg.norm(vb, axis=1), 128).reshape(vb.shape)
    err = np.abs(got - want)
    close = err <= 1e-6 * norm
    widths = np.repeat(np.asarray(plan.widths[chunk * plan.shard_nb:
                                              (chunk + 1) * plan.shard_nb]),
                       128).reshape(vb.shape)
    step = norm / (2.0 ** widths - 1)    # the resampled uniform 3-bit grid
    assert np.all(close | (err <= step * (1 + 1e-5))), err.max()
    assert (~close).mean() <= 1e-3


def _stats(nb, seed):
    rng = np.random.default_rng(seed)
    mu = rng.uniform(0.0, 0.2, nb).astype(np.float32)
    sigma = rng.uniform(0.02, 0.3, nb).astype(np.float32)
    norms = np.exp(rng.standard_normal(nb)).astype(np.float32)
    return mu, sigma, norms


@pytest.mark.parametrize("mean_bits,min_bits,max_bits,grid", [
    (3, 1, 8, "uniform"), (2, 1, 4, "uniform"), (4, 2, 8, "exp"),
    (5, 1, 8, "exp")])
def test_assign_mixed_widths_matches_reference(mean_bits, min_bits, max_bits,
                                               grid):
    """Random per-bucket statistics, without gains tied to the last ulp."""
    mu, sigma, norms = _stats(48, mean_bits)
    name = "alq" if grid == "uniform" else "amq"
    base = np.asarray(JScheme(name=name, bits=3).init_levels())
    kw = dict(mean_bits=mean_bits, min_bits=min_bits, max_bits=max_bits)
    want = jcodec.assign_mixed_widths(mu, sigma, norms, base, **kw)
    got = codec.assign_mixed_widths(mu, sigma, norms, base, **kw)
    assert got == want
    wire = [codec.packing.wire_bits_for(2 ** b) for b in got]
    assert sum(wire) <= 48 * codec.packing.wire_bits_for(2 ** mean_bits)


def test_mixed_widths_from_gradient_match_reference():
    jscheme = JScheme(name="alq", bits=3, bucket_size=256)
    scheme = QuantScheme(name="alq", bits=3, bucket_size=256)
    rng = np.random.default_rng(7)
    # buckets of different scales and tails: a spread of widths
    flat = (rng.standard_t(3, (49, 256))
            * np.exp(rng.standard_normal((49, 1)))).astype(np.float32)
    # 48 full buckets (the shapes of the test above) and a partial one
    flat = flat.reshape(-1)[:-100]
    want = jcodec.mixed_widths_from_gradient(flat, jscheme)
    got = codec.mixed_widths_from_gradient(torch.from_numpy(flat), scheme)
    assert got == want
    assert len(set(got)) > 2


@pytest.mark.parametrize("bits", range(1, 9))
def test_default_widths_are_budget_neutral(bits):
    jscheme, scheme, jc, tc = _pair(bits=bits, bs=256)
    assert tc.widths == jc.widths == (
        (bits,) if bits in (1, 8) else (bits - 1, bits + 1))
    uc = codec.codec_for_scheme(scheme)
    for shards in (1, 4):
        d = 256 * 64
        assert tc.plan(d, shards=shards).bits_per_coord == \
            uc.plan(d, shards=shards).bits_per_coord


def test_integrity_and_bad_widths_are_refused():
    scheme = QuantScheme(name="alq", bits=3, bucket_size=128)
    with pytest.raises(ValueError, match="integrity=True is not supported"):
        codec.make_codec(scheme, "mixed_width", integrity=True)
    with pytest.raises(ValueError, match="no integrity layout"):
        codec.MixedWidthCodec(bucket_size=128, widths=(2, 4), integrity=True)
    with pytest.raises(ValueError, match="non-empty"):
        codec.MixedWidthCodec(bucket_size=128)
    with pytest.raises(ValueError, match=r"\[1, 8\]"):
        codec.MixedWidthCodec(bucket_size=128, widths=(0, 9))


@pytest.mark.parametrize("mode", ["all_gather", "two_phase"])
def test_mixed_sync_matches_vmapped_reference(mode):
    M, d, bs = 4, 9000, 128
    jscheme, scheme, jc, tc = _pair((2, 4, 3), bs=bs)
    grads = _grads(M, d, seed=11)
    jstate = jscheme.init_state()

    def worker(g):
        return jsync.quantized_allreduce(g, jscheme, jstate, KEY,
                                         axes=("w",), mode=mode,
                                         use_pallas=False, codec=jc,
                                         return_own=True)

    jout, jown, jm = jax.jit(jax.vmap(worker, axis_name="w"))(
        jnp.asarray(grads))
    plan = tc.plan(d, shards=M if mode == "two_phase" else 1)
    u = [_uniforms(jax.random.fold_in(KEY, w), (plan.nb, bs))
         for w in range(M)]
    u2 = [_uniforms(jax.random.fold_in(jax.random.fold_in(KEY, r), 0x2FA5E),
                    (plan.shard_nb, bs)) for r in range(M)]
    out, own, m = sync.quantized_allreduce(
        torch.from_numpy(grads.copy()), scheme, scheme.init_state("cpu"),
        mode=mode, codec=tc, u=u, u2=u2, return_own=True)
    scale = np.abs(np.asarray(jown)).max()
    np.testing.assert_allclose(own.numpy(), np.asarray(jown), rtol=0,
                               atol=1e-6 * scale)
    if mode == "two_phase":
        assert_tie_rule(out.numpy(), np.asarray(jout[0]), bs)
    else:
        np.testing.assert_allclose(out.numpy(), np.asarray(jout[0]), rtol=0,
                                   atol=1e-6 * scale)
    for f in ("comm_bits_per_coord", "reduce_bits_per_coord",
              "broadcast_bits_per_coord"):
        assert getattr(m, f) == pytest.approx(float(getattr(jm, f)[0]),
                                              rel=1e-7), f

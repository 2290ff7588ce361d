"""The port's entropy-coded wire (``EntropyCodec``) against the reference.

Both packages get the same gradients (numpy, from a seed), the same
uniforms (the reference's ``jax.random`` draws) and the same Huffman table
(the reference's, copied by value).  Each reference call is jitted once
per shape, on small buckets, so that its ``lax.scan`` decode compiles fast.

Tolerances (ROADMAP, "How each slice is held"):
  * plans exact; header, region and checksum words exact (the codes are
    the same: a bucket norm that differs in the last ulp could move a code
    only where the reference's |u - rho| < 1e-5, and these inputs have no
    such tie);
  * the port's decode of the reference's words exact, and the port's own
    decode bit-exact with its uniform decode (entropy coding is lossless
    on the symbols);
  * validity masks exact under identical corruptions;
  * measured bits/coord at rtol 1e-6 (the reference sums in float32, the
    port in integers and one float64 division).
The gaussian-prior tables are built from ``level_probabilities``, whose
float32 erf differs from the reference's in the last ulps; the tables are
equal wherever no Huffman merge is a near-tie (held exact at the repo's
3-bit configurations), and elsewhere the port's table is a complete prefix
code whose expected length under the exact (float64) occupancies is
within 1e-4 of the reference table's (2e-2 on AMQ's exponential grid,
where both packages' float32 occupancies cancel; ROADMAP §3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codec as jcodec
from repro.core import coding as jcoding
from repro.core.schemes import QuantScheme as JScheme
from repro.dist import sync as jsync
from repro_torch.compress import make_algorithm
from repro_torch.core import codec, packing
from repro_torch.core.schemes import QuantScheme
from repro_torch.dist import sync

# one thread: xdist workers that each take every core starve one another
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(11)


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


def _port_codec(jc):
    """The port's codec of the same configuration and table."""
    return codec.EntropyCodec(**dataclasses.asdict(jc))


def _pair(name="alq", bits=3, bs=64, norm_dtype="float32", integrity=False,
          table="prior"):
    jscheme = JScheme(name=name, bits=bits, bucket_size=bs,
                      norm_dtype=norm_dtype)
    scheme = QuantScheme(name=name, bits=bits, bucket_size=bs,
                         norm_dtype=norm_dtype)
    if isinstance(table, str):
        jc = jcodec.entropy_codec_for_scheme(jscheme)
    else:
        jc = jcodec.entropy_wrap(jcodec.codec_for_scheme(jscheme), table)
    jc = dataclasses.replace(jc, integrity=integrity)
    return jscheme, scheme, jc, _port_codec(jc)


def _reference(jc, jplan, levels, key):
    @jax.jit
    def run(f):
        pay = jc.encode(jc.bucketize(f, jplan), levels, key, jplan,
                        use_pallas=False)
        return (pay, jc.decode(pay, levels, jplan, use_pallas=False),
                jc.measured_bits_per_coord(pay, jplan))
    return run


def _roundtrip(jscheme, scheme, jc, tc, flat, shards):
    """Both packages' payloads, the reference's decode, the port's
    decodes of the reference's and its own words, and its uniform
    decode."""
    d = flat.shape[0]
    jplan, plan = jc.plan(d, shards=shards), tc.plan(d, shards=shards)
    for f in plan._fields:
        assert getattr(plan, f) == getattr(jplan, f), f
    levels = jscheme.init_levels()
    tlevels = scheme.init_levels("cpu")
    jpay, jvals, jbits = _reference(jc, jplan, levels, KEY)(jnp.asarray(flat))
    u = _uniforms(KEY, (plan.nb, plan.bucket_size))
    tpay = tc.encode(tc.bucketize(torch.from_numpy(flat), plan), tlevels,
                     plan=plan, u=u)
    uc = codec.codec_for_scheme(scheme)
    uplan = uc.plan(d, shards=shards)
    upay = uc.encode(uc.bucketize(torch.from_numpy(flat), uplan), tlevels,
                     plan=uplan, u=u)
    return dict(jplan=jplan, plan=plan, jpay=jpay, jvals=np.asarray(jvals),
                jbits=float(jbits), tpay=tpay, tlevels=tlevels,
                ref_words=tc.decode(_as_port(jpay), tlevels, plan),
                own=tc.decode(tpay, tlevels, plan),
                uniform=uc.decode(upay, tlevels, uplan))


@pytest.mark.parametrize("d,shards,integrity,norm_dtype", [
    (1000, 1, False, "float32"), (5000, 4, True, "float16"),
    (70_001, 4, False, "float32"), (3000, 3, True, "float32")])
def test_plans_match_reference(d, shards, integrity, norm_dtype):
    _, _, jc, tc = _pair(bs=256, integrity=integrity, norm_dtype=norm_dtype)
    jplan, plan = jc.plan(d, shards=shards), tc.plan(d, shards=shards)
    for f in plan._fields:
        assert getattr(plan, f) == getattr(jplan, f), f
    assert plan.variable and plan.widths is None
    assert tc.cap_words == jc.cap_words
    assert tc.nominal_bits_per_coord == jc.nominal_bits_per_coord
    assert tc.chunkable and jc.chunkable


@pytest.mark.parametrize("bits", range(1, 9))
@pytest.mark.parametrize("norm_dtype", ["float32", "float16"])
def test_words_and_decode_match_reference_at_every_width(bits, norm_dtype):
    """The cold-start table, one unsharded stream of 64-coordinate
    buckets."""
    jscheme, scheme, jc, tc = _pair(bits=bits, norm_dtype=norm_dtype,
                                    table=None)
    flat = _grads(1, 1000 + bits, seed=bits)[0]
    r = _roundtrip(jscheme, scheme, jc, tc, flat, 1)
    assert r["tpay"].words.shape == (r["plan"].code_words,)
    np.testing.assert_array_equal(r["tpay"].words.numpy(),
                                  np.asarray(r["jpay"].words).view(np.int32))
    np.testing.assert_array_equal(r["ref_words"].numpy(), r["jvals"])
    assert torch.equal(r["own"], r["uniform"])
    np.testing.assert_allclose(tc.measured_bits_per_coord(r["tpay"],
                                                          r["plan"]),
                               r["jbits"], rtol=1e-6)


@pytest.mark.parametrize("bits,bs,integrity", [
    (2, 100, False), (3, 100, True), (3, 256, True), (8, 100, False)])
def test_sharded_words_and_decodes_match_reference(bits, bs, integrity):
    """The gaussian-prior table, 4 segments; buckets of 100 whose fixed
    packs do not fill whole words; the diagonal decode and each segment
    on its own."""
    jscheme, scheme, jc, tc = _pair(bits=bits, bs=bs, integrity=integrity,
                                    table=None if bits == 8 else "prior")
    flat = _grads(1, 31 * bs + 7, seed=bits + bs)[0]
    r = _roundtrip(jscheme, scheme, jc, tc, flat, 4)
    plan = r["plan"]
    assert r["tpay"].words.shape == (4, plan.code_words)
    c = plan.shard_nb if integrity else 0
    tw = r["tpay"].words.numpy()
    jw = np.asarray(r["jpay"].words).view(np.int32)
    np.testing.assert_array_equal(tw[:, c:], jw[:, c:])
    if integrity:  # checksums cover norm bits: equal where they agree
        same = (r["tpay"].norm_words.numpy()
                == np.asarray(r["jpay"].norm_words).view(np.int32))
        np.testing.assert_array_equal(tw[:, :c][same], jw[:, :c][same])
    np.testing.assert_array_equal(r["ref_words"].numpy(), r["jvals"])
    assert torch.equal(r["own"], r["uniform"])
    as_port = _as_port(r["jpay"])
    for s in range(4):
        one = tc.decode(type(as_port)(as_port.words[s][None],
                                      as_port.norm_words[s][None]),
                        r["tlevels"], plan, shard=s)
        np.testing.assert_array_equal(one[0].numpy(), r["jvals"][s])
    np.testing.assert_allclose(tc.measured_bits_per_coord(r["tpay"], plan),
                               r["jbits"], rtol=1e-6)


@pytest.mark.parametrize("bs", [100, 256])
def test_forced_fallback_is_flagged_and_bit_exact(bs):
    """A table fit to 'everything is zero' and uniform magnitudes on an
    L-inf grid overflow every bucket's capacity: each bucket falls back to
    its fixed-width pack, flag bit set, as in the reference."""
    skew = np.zeros(8)
    skew[0] = 1.0
    jscheme, scheme, jc, tc = _pair(name="qsgdinf", bs=bs, table=skew)
    flat = np.random.default_rng(1).uniform(-1, 1, bs * 16).astype(
        np.float32)
    r = _roundtrip(jscheme, scheme, jc, tc, flat, 1)
    plan = r["plan"]
    words = r["tpay"].words.numpy()
    np.testing.assert_array_equal(words,
                                  np.asarray(r["jpay"].words).view(np.int32))
    assert (words[:plan.shard_nb] < 0).all()        # bit 31 of every header
    np.testing.assert_array_equal(r["ref_words"].numpy(), r["jvals"])
    assert torch.equal(r["own"], r["uniform"])
    mb = tc.measured_bits_per_coord(r["tpay"], plan)
    np.testing.assert_allclose(mb, r["jbits"], rtol=1e-6)
    np.testing.assert_allclose(mb, plan.bits_per_coord, rtol=1e-6)
    assert mb >= codec.codec_for_scheme(scheme).plan(bs * 16).bits_per_coord


def _corrupt(words, nwords, case, snb, cap):
    words, nwords = words.copy(), nwords.copy()
    if case == "zero-row":
        return np.zeros_like(words), np.zeros_like(nwords)
    flip = {"checksum": (2, 1), "header-length": (snb + 3, 1 << 20),
            "header-flag": (snb + 5, 1 << 31),
            "region": (2 * snb + 7 * cap + 1, 1 << 9)}
    if case == "norm":
        nwords[4] ^= np.uint32(1 << 30)
    elif case != "clean":
        i, m = flip[case]
        words[i] ^= np.uint32(m)
    return words, nwords


def test_decode_checked_masks_match_reference_under_corruptions():
    jscheme, scheme, jc, tc = _pair(bs=256, integrity=True)
    d = 40 * 256
    jplan, plan = jc.plan(d), tc.plan(d)
    levels = jscheme.init_levels()
    tlevels = scheme.init_levels("cpu")
    jpay = _reference(jc, jplan, levels, KEY)(
        jnp.asarray(_grads(1, d, seed=4)[0]))[0]
    check = jax.jit(lambda p: jc.decode_checked(p, levels, jplan,
                                                use_pallas=False))
    words, nwords = np.asarray(jpay.words), np.asarray(jpay.norm_words)
    for case in ("clean", "checksum", "header-length", "header-flag",
                 "region", "norm", "zero-row"):
        w, n = _corrupt(words, nwords, case, plan.shard_nb, tc.cap_words)
        jvals, jvalid = check(type(jpay)(jnp.asarray(w), jnp.asarray(n)))
        vals, valid = tc.decode_checked(
            codec.WirePayload(torch.from_numpy(w.view(np.int32)),
                              torch.from_numpy(n.view(np.int32))),
            tlevels, plan)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid),
                                      err_msg=case)
        ok = np.repeat(valid.numpy(), 256)
        np.testing.assert_array_equal(vals.numpy()[ok],
                                      np.asarray(jvals)[ok], err_msg=case)
        if case == "clean":
            assert bool(valid.all())
        elif case == "zero-row":
            assert not bool(valid.any())
        else:
            assert int((~valid).sum()) == 1, case
        # a corrupt header bills at most the bucket's capacity
        np.testing.assert_allclose(
            tc.measured_bits_per_coord(
                codec.WirePayload(torch.from_numpy(w.view(np.int32)), None),
                plan),
            float(jc.measured_bits_per_coord(
                type(jpay)(jnp.asarray(w), None), jplan)), rtol=1e-6)


@pytest.mark.parametrize("name,bits,bs", [
    ("alq", 1, 1024), ("alq", 2, 1024), ("alq", 3, 1024), ("alq", 3, 8192),
    ("alq", 3, 256), ("alq_n", 3, 1024), ("amq", 3, 8192),
    ("qsgdinf", 3, 1024), ("qsgdinf", 6, 8192)])
def test_gaussian_prior_tables_match_reference(name, bits, bs):
    kw = dict(name=name, bits=bits, bucket_size=bs)
    j = jcodec.entropy_codec_for_scheme(JScheme(**kw))
    t = codec.entropy_codec_for_scheme(QuantScheme(**kw))
    assert (t.huff_lengths, t.huff_codes) == (j.huff_lengths, j.huff_codes)
    kinds = {k: codec.make_codec(QuantScheme(**kw), k)
             for k in ("entropy", "entropy:uniform")}
    assert all(c == t for c in kinds.values())
    cold = codec.entropy_wrap(codec.codec_for_scheme(QuantScheme(**kw)))
    jcold = jcodec.entropy_wrap(jcodec.codec_for_scheme(JScheme(**kw)))
    assert cold == _port_codec(jcold)


@pytest.mark.parametrize("name,bits,bs,rel", [
    ("alq", 8, 64, 1e-4), ("qsgdinf", 8, 8192, 1e-4), ("amq", 6, 1024, 2e-2)])
def test_tables_at_near_ties_are_as_good_as_the_reference(name, bits, bs,
                                                          rel):
    """Where the level occupancies of a fine grid differ from the
    reference's in the last ulps, Huffman merges tied to that noise may go
    the other way.  The port's table is still a complete prefix code, and
    under the exact (float64) occupancies its expected length is within
    ``rel`` of the reference table's.  On the 64-level exponential grid
    both packages' float32 occupancies are far from the exact ones
    (cancellation between levels 2^-k apart), so the tables differ more
    there."""
    from repro_torch.core import coding
    from repro_torch.core.stats import TruncNormStats
    kw = dict(name=name, bits=bits, bucket_size=bs)
    j = jcodec.entropy_codec_for_scheme(JScheme(**kw))
    scheme = QuantScheme(**kw)
    t = codec.entropy_codec_for_scheme(scheme)
    lengths = np.asarray(t.huff_lengths)
    assert np.sum(2.0 ** -lengths) == 1.0                   # Kraft equality
    assert t.huff_codes == tuple(int(c) for c in jcoding.canonical_code(
        lengths))
    scale = (1.0 / np.sqrt(2.0 * np.log(bs)) if name == "qsgdinf"
             else 1.0 / np.sqrt(bs))
    exact = coding.level_probabilities(
        scheme.init_levels("cpu").double(),
        TruncNormStats(*(torch.tensor([v], dtype=torch.float64)
                         for v in (scale, scale, 1.0)))).numpy()
    joint = np.clip(coding.signed_symbol_probabilities(exact), 2.0 ** -20,
                    None)
    joint /= joint.sum()
    want = float(joint @ np.asarray(j.huff_lengths))
    assert float(joint @ lengths) == pytest.approx(want, rel=rel)


def test_fitted_table_measures_below_fixed_width():
    """The probe protocol: one gradient -> a fitted table, the same in
    both packages at 3 bits; its measured volume beats the uniform plan,
    and a sharded layout bills almost the same."""
    jscheme = JScheme(name="alq", bits=3, bucket_size=256)
    scheme = QuantScheme(name="alq", bits=3, bucket_size=256)
    flat = _grads(1, 64 * 256, seed=6)[0]
    j = jcodec.entropy_codec_from_gradient(flat, jscheme,
                                           jscheme.init_levels())
    t = codec.entropy_codec_from_gradient(torch.from_numpy(flat), scheme,
                                          scheme.init_levels("cpu"))
    assert t == _port_codec(j)
    lv = scheme.init_levels("cpu")
    u = torch.from_numpy(np.random.default_rng(0).random(
        (64, 256), dtype=np.float32))
    mb = {}
    for shards in (1, 4):
        plan = t.plan(flat.size, shards=shards)
        pay = t.encode(t.bucketize(torch.from_numpy(flat), plan), lv,
                       plan=plan, u=u)
        mb[shards] = t.measured_bits_per_coord(pay, plan)
    uniform = codec.codec_for_scheme(scheme).plan(flat.size)
    assert mb[1] < uniform.bits_per_coord
    assert mb[4] == pytest.approx(mb[1], rel=0.02)


def test_sync_metrics_match_reference():
    """all_gather and two_phase + integrity over the entropy wire, 4
    workers: the aggregate as the uniform wire's tie rule holds it, and
    worker 0's measured bits at rtol 1e-6."""
    from test_torch_two_phase import assert_tie_rule
    M, d, bs = 4, 8000, 256
    jscheme, scheme, jc, tc = _pair(bs=bs)
    grads = _grads(M, d, seed=2)
    for mode, integrity in (("all_gather", False), ("two_phase", True)):
        jcc = dataclasses.replace(jc, integrity=integrity)
        tcc = _port_codec(jcc)
        jstate = jscheme.init_state()

        def worker(g):
            return jsync.quantized_allreduce(
                g, jscheme, jstate, KEY, axes=("w",), mode=mode,
                use_pallas=False, codec=jcc)

        jout, jm = jax.jit(jax.vmap(worker, axis_name="w"))(
            jnp.asarray(grads))
        plan = tcc.plan(d, shards=M if mode == "two_phase" else 1)
        u = [_uniforms(jax.random.fold_in(KEY, w), (plan.nb, bs))
             for w in range(M)]
        u2 = [_uniforms(jax.random.fold_in(jax.random.fold_in(KEY, r),
                                           0x2FA5E), (plan.shard_nb, bs))
              for r in range(M)]
        out, m = sync.quantized_allreduce(
            torch.from_numpy(grads.copy()), scheme, scheme.init_state("cpu"),
            mode=mode, codec=tcc, u=u, u2=u2)
        if mode == "all_gather":
            scale = np.abs(grads).max()
            np.testing.assert_allclose(out.numpy(), np.asarray(jout[0]),
                                       rtol=0, atol=1e-6 * scale)
        else:
            assert_tie_rule(out.numpy(), np.asarray(jout[0]), bs)
        for f in ("comm_bits_per_coord", "reduce_bits_per_coord",
                  "broadcast_bits_per_coord"):
            np.testing.assert_allclose(getattr(m, f),
                                       float(getattr(jm, f)[0]), rtol=1e-6,
                                       err_msg=f)
        assert not bool(m.corrupt_fraction.any())


def test_ef_over_entropy_equals_ef_over_uniform():
    """Error feedback stacked on the entropy wire: aggregate and residuals
    bit-exact with ef over the uniform wire (the same symbols travel)."""
    M, d, bs = 4, 6000, 256
    scheme = QuantScheme(name="qsgdinf", bits=2, bucket_size=bs)
    grads = torch.from_numpy(_grads(M, d, seed=3))
    outs = []
    for c in (None, codec.make_codec(scheme, "entropy")):
        algo = make_algorithm("ef", scheme, codec=c)
        state = algo.init_state(M, d, "cpu")
        state.residual.copy_(grads * 0.3)
        plan = algo.codec.plan(d)
        g = torch.Generator().manual_seed(5)
        u = [torch.rand(plan.nb, bs, generator=g) for _ in range(M)]
        out, state, m = sync.compressed_allreduce(
            grads.clone(), scheme, scheme.init_state("cpu"), algo, state,
            u=u)
        outs.append((out, state.residual))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_configuration_errors_match_reference():
    scheme = QuantScheme(name="alq", bits=3, bucket_size=256)
    ec = codec.entropy_wrap(codec.codec_for_scheme(scheme))
    with pytest.raises(ValueError, match="SparseCodec"):
        make_algorithm("topk", scheme, codec=ec)
    with pytest.raises(ValueError, match="uniform"):
        codec.entropy_wrap(codec.MixedWidthCodec(bucket_size=256,
                                                 widths=(2, 4)))
    with pytest.raises(ValueError, match="uniform"):
        codec.make_codec(scheme, "entropy:mixed_width")
    with pytest.raises(ValueError, match="signed"):
        codec.EntropyCodec(num_levels=8, bucket_size=256, huff_lengths=(3,),
                           huff_codes=(0,))
    with pytest.raises(ValueError, match=r"\[1, 32\]"):
        codec.EntropyCodec(num_levels=1, bucket_size=256, huff_lengths=(0,),
                           huff_codes=(0,))
    with pytest.raises(ValueError, match="unknown codec kind"):
        codec.make_codec(scheme, "huffman")
    assert isinstance(codec.make_codec(scheme, "entropy", integrity=True),
                      codec.EntropyCodec)
    # the codec's packing of an int32 header: bit 31 is the sign bit
    assert packing.from_int32_bits(torch.tensor([-1])).item() == 2 ** 32 - 1

"""The port's two_phase sync mode against the reference package.

Both packages get the same gradients (numpy, from a seed) and the same
uniforms: phase 1's are the reference's draws from fold_in(key, w) for
worker w, phase 2's from fold_in(fold_in(key, r), 0x2FA5E) for rank r
(``quantized_allreduce`` folds in the rank, ``_allreduce_two_phase`` the
phase-2 constant).  The reference runs its kernels' plain versions under
``jax.vmap`` with a named worker axis, jitted once per case.

Tolerances (ROADMAP, "How each slice is held"):
  * plans and bits/coord exact;
  * symbol words exact; a checksum word exact where its bucket's norm
    bits agree, and otherwise the reference's checksum of the port's own
    symbols and norm bits (a norm may differ in the last ulp);
  * the phase-2 payload exact when both encodes get the same shard mean;
  * the aggregate under the tie rule: a coordinate is within 1e-6 of its
    phase-2 bucket's norm (norms summed in another order differ in the
    last ulp), or, at no more than 0.1% of the coordinates, one phase-2
    level step off (a rounding tie that the ulp moved);
  * quant_error rtol 1e-5; corrupt_fraction and excluded_workers exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codec as jcodec
from repro.core.levels import uniform_levels as juniform_levels
from repro.core.schemes import QuantScheme as JScheme
from repro.dist import sync as jsync
from repro_torch.core import codec
from repro_torch.core.levels import uniform_levels
from repro_torch.core.packing import unpack_norms
from repro_torch.core.schemes import QuantScheme
from repro_torch.dist import sync

# one thread: xdist workers that each take every core starve one another
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(23)
PHASE2_FOLD = 0x2FA5E


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


def _codecs(integrity, norm_dtype="float32", bs=256, bits=3):
    kw = dict(name="alq", bits=bits, bucket_size=bs, norm_dtype=norm_dtype)
    jc = dataclasses.replace(jcodec.codec_for_scheme(JScheme(**kw)),
                             integrity=integrity)
    tc = codec.make_codec(QuantScheme(**kw), integrity=integrity)
    return JScheme(**kw), QuantScheme(**kw), jc, tc


@pytest.mark.parametrize("integrity", [False, True])
@pytest.mark.parametrize("d,shards", [(1000, 1), (5000, 4), (70_001, 4),
                                      (3000, 3)])
def test_sharded_plans_match_reference(d, shards, integrity):
    _, _, jc, tc = _codecs(integrity)
    jplan, plan = jc.plan(d, shards=shards), tc.plan(d, shards=shards)
    for f in plan._fields:
        assert getattr(plan, f) == getattr(jplan, f), f
    assert (plan.shard_nb, plan.shard_n) == (jplan.shard_nb, jplan.shard_n)
    j2, t2 = jcodec.requant_codec(jc, 8), codec.requant_codec(tc, 8)
    assert t2 == codec.UniformCodec(**dataclasses.asdict(j2))
    jp2, tp2 = j2.plan_buckets(plan.shard_nb), t2.plan_buckets(plan.shard_nb)
    for f in tp2._fields:
        assert getattr(tp2, f) == getattr(jp2, f), f


def assert_words_match(tpay, jpay, plan, norm_dtype, num_levels=8):
    """Symbol words exact.  A checksum word covers its bucket's norm
    bits, and a norm may differ in the last ulp: each checksum word must
    be the reference's ``bucket_checksums`` of the port's own symbols and
    norm bits, and equal the reference's word where the norm bits agree."""
    P = jcodec.packing
    words = tpay.words.reshape(plan.shards, -1).numpy()
    jwords = np.asarray(jpay.words).view(np.int32).reshape(plan.shards, -1)
    c = plan.shard_nb if plan.integrity else 0
    np.testing.assert_array_equal(words[:, c:], jwords[:, c:])
    if not plan.integrity:
        return
    nwords = tpay.norm_words.reshape(plan.shards, -1)
    jnwords = np.asarray(jpay.norm_words).reshape(plan.shards, -1)
    for s in range(plan.shards):
        nbits = P.norm_bit_patterns(jnp.asarray(unpack_norms(
            nwords[s], plan.shard_nb, norm_dtype).numpy()), norm_dtype)
        jnbits = P.norm_bit_patterns(P.unpack_norms(
            jnwords[s], plan.shard_nb, norm_dtype), norm_dtype)
        sym = P.unpack(jnp.asarray(words[s, c:].view(np.uint32)),
                       plan.shard_n, P.wire_bits_for(num_levels))
        want = np.asarray(P.bucket_checksums(
            sym.reshape(plan.shard_nb, plan.bucket_size),
            nbits)).view(np.int32)
        np.testing.assert_array_equal(words[s, :c], want)
        same = np.asarray(nbits == jnbits)
        np.testing.assert_array_equal(words[s, :c][same],
                                      jwords[s, :c][same])


@pytest.mark.parametrize("integrity,norm_dtype", [
    (False, "float32"), (True, "float32"), (True, "float16")])
def test_sharded_encode_and_decode_match_reference(integrity, norm_dtype):
    M, d = 4, 9000
    _, scheme, jc, tc = _codecs(integrity, norm_dtype)
    jplan, plan = jc.plan(d, shards=M), tc.plan(d, shards=M)
    levels = jnp.asarray(scheme.init_levels("cpu").numpy())
    tlevels = scheme.init_levels("cpu")
    flat = _grads(1, d, seed=3)[0]
    key = jax.random.fold_in(KEY, 2)

    @jax.jit
    def reference(f):
        vb = jc.bucketize(f, jplan)
        pay = jc.encode(vb, levels, key, jplan, use_pallas=False)
        own = jc.decode(pay, levels, jplan, shard=None, use_pallas=False)
        seg = type(pay)(pay.words[1], pay.norm_words[1])
        return pay, own, jc.decode_checked(seg, levels, jplan, shard=1,
                                           use_pallas=False)

    jpay, jown, (jseg, jvalid) = reference(jnp.asarray(flat))
    tvb = tc.bucketize(torch.from_numpy(flat), plan)
    tpay = tc.encode(tvb, tlevels, plan=plan,
                     u=_uniforms(key, (plan.nb, plan.bucket_size)))
    assert tpay.words.shape == (M, plan.code_words)
    assert_words_match(tpay, jpay, plan, norm_dtype)
    for s in range(M):
        np.testing.assert_allclose(
            unpack_norms(tpay.norm_words[s], plan.shard_nb,
                         norm_dtype).numpy(),
            np.asarray(jcodec.packing.unpack_norms(
                jpay.norm_words[s], plan.shard_nb, norm_dtype)),
            rtol=1e-6 if norm_dtype == "float32" else 1e-3)
    # the port decodes the reference's words exactly, own and one segment
    as_port = _as_port(jpay)
    np.testing.assert_array_equal(
        tc.decode(as_port, tlevels, plan).numpy(), np.asarray(jown))
    seg, valid = tc.decode_checked(
        type(as_port)(as_port.words[1], as_port.norm_words[1]), tlevels,
        plan, shard=1)
    np.testing.assert_array_equal(seg.numpy(), np.asarray(jseg))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert bool(valid.all())


@pytest.mark.parametrize("integrity", [False, True])
def test_phase2_payload_from_one_shard_mean_is_bit_exact(integrity):
    """The re-quantization hop: both packages encode the same shard mean
    on the 8-bit L-inf grid with the same uniforms."""
    _, _, jc, tc = _codecs(integrity, bs=512)
    j2, t2 = jcodec.requant_codec(jc, 8), codec.requant_codec(tc, 8)
    snb = 24
    mean = _grads(1, snb * 512, seed=5)[0].reshape(snb, 512)
    mean[3] = 0.0                         # a padding bucket
    key = jax.random.fold_in(jax.random.fold_in(KEY, 1), PHASE2_FOLD)
    lv2 = juniform_levels(8)
    jplan2 = j2.plan_buckets(snb)

    @jax.jit
    def reference(v):
        pay = j2.encode(v, lv2, key, jplan2, use_pallas=False)
        return pay, j2.decode(pay, lv2, jplan2, use_pallas=False)

    jpay, jvals = reference(jnp.asarray(mean))
    tpay = t2.encode(torch.from_numpy(mean), uniform_levels(8, device="cpu"),
                     u=_uniforms(key, mean.shape))
    np.testing.assert_array_equal(tpay.words.numpy(),
                                  np.asarray(jpay.words).view(np.int32))
    # L-inf norms are a max: exact
    np.testing.assert_array_equal(tpay.norm_words.numpy(),
                                  np.asarray(jpay.norm_words).view(np.int32))
    np.testing.assert_array_equal(
        t2.decode(tpay, uniform_levels(8, device="cpu"),
                  t2.plan_buckets(snb)).numpy(), np.asarray(jvals))


def _reference_two_phase(jscheme, jc, grads):
    jstate = jscheme.init_state()

    def worker(g):
        return jsync.quantized_allreduce(g, jscheme, jstate, KEY,
                                         axes=("w",), mode="two_phase",
                                         use_pallas=False, codec=jc,
                                         return_own=True)

    return jax.jit(jax.vmap(worker, axis_name="w"))(jnp.asarray(grads))


def _port_uniforms(plan, M):
    u = [_uniforms(jax.random.fold_in(KEY, w), (plan.nb, plan.bucket_size))
         for w in range(M)]
    u2 = [_uniforms(jax.random.fold_in(jax.random.fold_in(KEY, r),
                                       PHASE2_FOLD),
                    (plan.shard_nb, plan.bucket_size)) for r in range(M)]
    return u, u2


def assert_tie_rule(out, want, bucket_size, slack=0.0):
    """``out`` against the reference's two_phase aggregate ``want``: each
    coordinate within 1e-6 of its phase-2 bucket's L-inf norm (the
    largest |value| of a decoded L-inf bucket is its norm), or one
    phase-2 level step off at no more than 0.1% of the coordinates.
    ``slack`` adds a per-coordinate rounding allowance of the caller's."""
    n = -(-want.size // bucket_size) * bucket_size
    pad = np.zeros(n - want.size, np.float32)
    norm2 = np.abs(np.concatenate([want, pad])).reshape(-1, bucket_size)
    norm2 = np.repeat(norm2.max(axis=1), bucket_size)[:want.size]
    err = np.abs(out - want)
    close = err <= 1e-6 * norm2 + slack + 1e-30
    step = norm2 / 255.0
    assert np.all(close | (np.abs(err - step) <= 1e-5 * norm2 + slack)), \
        err.max()
    assert (~close).mean() <= 1e-3, (~close).sum()


@pytest.mark.parametrize("M,d", [(1, 3000), (4, 9000)])
@pytest.mark.parametrize("integrity", [False, True])
def test_two_phase_allreduce_matches_vmapped_reference(M, d, integrity):
    jscheme, scheme, jc, tc = _codecs(integrity)
    grads = _grads(M, d, seed=M)
    jout, jown, jm = _reference_two_phase(jscheme, jc, grads)
    plan = tc.plan(d, shards=M)
    u, u2 = _port_uniforms(plan, M)
    out, own, m = sync.quantized_allreduce(
        torch.from_numpy(grads.copy()), scheme, scheme.init_state("cpu"),
        mode="two_phase", codec=tc, u=u, u2=u2, return_own=True)
    assert out.shape == (d,)
    for w in range(M):  # every reference worker holds the same aggregate
        assert_tie_rule(out.numpy(), np.asarray(jout[w]), plan.bucket_size)
    # own round trips: each term within its norm's last ulp
    scale = np.abs(np.asarray(jown)).max()
    np.testing.assert_allclose(own.numpy(), np.asarray(jown), rtol=0,
                               atol=1e-6 * scale)
    for f in ("comm_bits_per_coord", "reduce_bits_per_coord",
              "broadcast_bits_per_coord"):
        assert getattr(m, f) == pytest.approx(float(getattr(jm, f)[0]),
                                              rel=1e-7), f
    np.testing.assert_allclose(m.quant_error.numpy(),
                               np.asarray(jm.quant_error), rtol=1e-5)
    np.testing.assert_array_equal(m.corrupt_fraction.numpy(),
                                  np.asarray(jm.corrupt_fraction))
    np.testing.assert_array_equal(m.excluded_workers.numpy(),
                                  np.asarray(jm.excluded_workers))


def test_two_phase_draws_from_a_generator_when_no_uniforms_are_given():
    _, scheme, _, tc = _codecs(False)
    grads = torch.from_numpy(_grads(4, 5000))

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return sync.quantized_allreduce(grads.clone(), scheme,
                                        scheme.init_state("cpu"),
                                        mode="two_phase", generator=g)[0]

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))


def test_unknown_mode_is_refused():
    scheme = QuantScheme(bucket_size=128)
    with pytest.raises(ValueError, match="unknown sync mode"):
        sync.quantized_allreduce(torch.zeros(2, 100), scheme,
                                 scheme.init_state("cpu"), mode="ring")

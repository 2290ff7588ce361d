"""Wire integrity, masked means and fault injection, port against the
reference package.

Checksum words and validity masks are exact, on clean payloads and on
payloads that both packages corrupt the same way (a flipped symbol word,
a flipped norm word, a checksum word, a zeroed row).  The masked means
(``mean_workers_bucketed``, ``MaskedTransport``) hold against the
reference's within 1e-6 of their terms' scale (weighted sums in another
order) and against each other bit for bit when a whole worker is
invalid.  Fault draws cannot match ``jax.random``'s, so
``FaultyTransport`` is held to its probabilities and to the reference's
semantics: a corrupted worker leaves the aggregate exactly as a masked
one (in two_phase its own shard of phase 2 zero-fills), an all-dropped
wire gives zeros, and a run is reproducible in (seed, step).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codec as jcodec
from repro.core import packing as jpacking
from repro.core.schemes import QuantScheme as JScheme
from repro.dist import sync as jsync
from repro.dist import transport as jtransport
from repro_torch.core import codec, packing
from repro_torch.core.schemes import QuantScheme
from repro_torch.dist import sync
from repro_torch.dist.faults import FaultModel, FaultyTransport, faulty
from repro_torch.dist.transport import (
    MaskedTransport, StackedTransport, make_transport)

# one thread: xdist workers that each take every core starve one another
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(7)
M, D, BS = 4, 6144, 256
KW = dict(name="alq", bits=3, bucket_size=BS)
JSCHEME, SCHEME = JScheme(**KW), QuantScheme(**KW)


def _grads(M, d, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, d)) * 1e-2).astype(np.float32)


GRADS = _grads(M, D)


def _uniforms(key, shape):
    return torch.from_numpy(np.array(
        jax.random.uniform(key, shape, jnp.float32)))


@pytest.mark.parametrize("bits,bs,norm_dtype", [
    (3, 256, "float32"), (8, 1024, "float32"), (2, 100, "float16")])
def test_checksums_and_norm_bits_match_reference(bits, bs, norm_dtype):
    rng = np.random.default_rng(bits)
    L = 2 ** bits
    sym = rng.integers(0, 2 * L - 1, (37, bs)).astype(np.uint32)
    sym[3] = 0
    norms = np.abs(rng.standard_normal(37)).astype(np.float32)
    norms[[3, 4]] = [0.0, np.inf]
    jbits = jpacking.norm_bit_patterns(jnp.asarray(norms), norm_dtype)
    tbits = packing.norm_bit_patterns(torch.from_numpy(norms), norm_dtype)
    np.testing.assert_array_equal(tbits.numpy(),
                                  np.asarray(jbits).view(np.int32))
    want = np.asarray(jpacking.bucket_checksums(jnp.asarray(sym), jbits))
    got = packing.bucket_checksums(
        torch.from_numpy(sym.astype(np.int32)), tbits)
    np.testing.assert_array_equal(got.numpy(), want.view(np.int32))


def test_checksums_at_the_largest_words():
    """Every symbol and norm bit set: the int64 arithmetic reduced mod
    2**32 matches the reference's wrapping uint32."""
    sym = np.full((3, 8192), 510, np.uint32)
    nbits = np.full(3, 0xFFFFFFFF, np.uint32)
    want = jpacking.bucket_checksums(jnp.asarray(sym), jnp.asarray(nbits))
    got = packing.bucket_checksums(torch.from_numpy(sym.astype(np.int32)),
                                   torch.from_numpy(nbits.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).view(np.int32))


def _corruptions(plan):
    """(name, word index, flip mask, norm word index) of the corruptions
    both packages receive: a checksum word, a symbol word, a norm word,
    and the whole row zeroed (index None)."""
    return [("checksum", 5, 1, None), ("symbol", plan.nb + 3, 1 << 17, None),
            ("symbol-top-bit", plan.nb + 40, 1 << 31, None),
            ("norm", None, 1 << 30, 7), ("zero-row", None, 0, None)]


def _corrupt(words, nwords, case):
    name, wi, flip, ni = case
    words, nwords = words.copy(), nwords.copy()
    if name == "zero-row":
        return np.zeros_like(words), np.zeros_like(nwords)
    if wi is not None:
        words[wi] ^= np.uint32(flip)
    if ni is not None:
        nwords[ni] ^= np.uint32(flip)
    return words, nwords


@pytest.mark.parametrize("norm_dtype", ["float32", "float16"])
def test_validity_masks_match_reference_clean_and_corrupted(norm_dtype):
    jc = dataclasses.replace(jcodec.codec_for_scheme(
        JScheme(**KW, norm_dtype=norm_dtype)), integrity=True)
    tc = codec.make_codec(QuantScheme(**KW, norm_dtype=norm_dtype),
                          integrity=True)
    plan = tc.plan(D)
    levels = JSCHEME.init_levels()
    vb = jc.bucketize(jnp.asarray(GRADS[0]), jc.plan(D))
    jpay = jax.jit(lambda v: jc.encode(v, levels, KEY, jc.plan(D),
                                       use_pallas=False))(vb)
    check = jax.jit(lambda p: jc.decode_checked(p, levels, jc.plan(D),
                                                use_pallas=False))
    tlevels = SCHEME.init_levels("cpu")
    words, nwords = np.asarray(jpay.words), np.asarray(jpay.norm_words)
    for case in [("clean", None, 0, None)] + _corruptions(plan):
        w, n = _corrupt(words, nwords, case)
        jvals, jvalid = check(type(jpay)(jnp.asarray(w), jnp.asarray(n)))
        tpay = codec.WirePayload(torch.from_numpy(w.view(np.int32)),
                                 torch.from_numpy(n.view(np.int32)))
        vals, valid = tc.decode_checked(tpay, tlevels, plan)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid),
                                      err_msg=case[0])
        ok = np.repeat(valid.numpy(), BS)
        np.testing.assert_array_equal(vals.numpy()[ok],
                                      np.asarray(jvals)[ok], err_msg=case[0])
        if case[0] == "clean":
            assert bool(valid.all())
        elif case[0] == "zero-row":
            assert not bool(valid.any())
        else:
            assert int((~valid).sum()) == 1, case[0]


def test_port_checksums_flag_exactly_the_corrupted_bucket():
    tc = codec.make_codec(SCHEME, integrity=True)
    plan = tc.plan(D)
    lv = SCHEME.init_levels("cpu")
    pay = tc.encode(tc.bucketize(torch.from_numpy(GRADS[0]), plan), lv,
                    generator=torch.Generator().manual_seed(0))
    assert bool(tc.decode_checked(pay, lv, plan)[1].all())
    words = pay.words.clone()
    words[5] ^= 1
    valid = tc.decode_checked(pay._replace(words=words), lv, plan)[1]
    assert not valid[5] and int(valid.sum()) == plan.nb - 1


def _masked_means(stacked, valid, active):
    jt = (jtransport.MeshTransport(()) if active is None
          else jtransport.MaskedTransport((), jnp.asarray(active)))
    jb = jt.mean_workers_bucketed(jnp.asarray(stacked), jnp.asarray(valid),
                                  BS)
    jm = jt.mean_workers(jnp.asarray(stacked))
    t = make_transport(stacked.shape[0], None if active is None
                       else torch.tensor(active))
    tb = t.mean_workers_bucketed(torch.from_numpy(stacked),
                                 torch.from_numpy(valid), BS)
    tm = t.mean_workers(torch.from_numpy(stacked))
    return np.asarray(jb), np.asarray(jm), tb.numpy(), tm.numpy()


@pytest.mark.parametrize("active", [None, [1.0, 1.0, 0.0, 1.0],
                                    [0.0, 0.0, 0.0, 0.0]])
def test_masked_means_match_reference(active):
    stacked = _grads(M, 8 * BS, seed=4)
    rng = np.random.default_rng(5)
    valid = rng.random((M, 8)) > 0.3
    valid[:, 2] = False                    # an all-invalid bucket
    stacked[~np.repeat(valid, BS, axis=1)] = np.nan  # never leaks
    # a weighted sum in another order: within 1e-6 of its terms' scale
    scale = 1e-6 * np.nanmax(np.abs(stacked))
    jb, jm, tb, tm = _masked_means(stacked, valid, active)
    np.testing.assert_allclose(tb, jb, rtol=0, atol=scale)
    assert np.all(tb[2 * BS:3 * BS] == 0.0)
    clean = np.nan_to_num(stacked)
    jb, jm, tb, tm = _masked_means(clean, np.ones((M, 8), bool), active)
    np.testing.assert_allclose(tb, jb, rtol=0, atol=scale)
    np.testing.assert_allclose(tm, jm, rtol=0, atol=scale)


def test_whole_invalid_worker_is_exactly_a_masked_worker():
    stacked = torch.from_numpy(_grads(M, 8 * BS, seed=6))
    valid = torch.ones(M, 8, dtype=torch.bool)
    valid[2] = False
    bucketed = StackedTransport(M).mean_workers_bucketed(stacked, valid, BS)
    masked = MaskedTransport(torch.tensor([1.0, 1.0, 0.0, 1.0]))
    assert torch.equal(bucketed, masked.mean_workers(stacked))
    # and all-valid masks give the plain mean to the last ulp
    allv = StackedTransport(M).mean_workers_bucketed(
        stacked, torch.ones(M, 8, dtype=torch.bool), BS)
    torch.testing.assert_close(allv, stacked.mean(0), rtol=1e-6, atol=1e-12)
    w = masked.weights()
    assert float(w.sum()) == pytest.approx(1.0) and float(w[2]) == 0.0


def test_all_gather_integrity_matches_vmapped_reference():
    jc = dataclasses.replace(jcodec.codec_for_scheme(JSCHEME),
                             integrity=True)
    tc = codec.make_codec(SCHEME, integrity=True)
    jstate = JSCHEME.init_state()

    def worker(g):
        return jsync.quantized_allreduce(g, JSCHEME, jstate, KEY,
                                         axes=("w",), use_pallas=False,
                                         codec=jc, return_own=True)

    jout, jown, jm = jax.jit(jax.vmap(worker, axis_name="w"))(
        jnp.asarray(GRADS))
    plan = tc.plan(D)
    assert plan.bits_per_coord == pytest.approx(
        float(jm.comm_bits_per_coord[0]), rel=1e-7)
    u = [_uniforms(jax.random.fold_in(KEY, w), (plan.nb, BS))
         for w in range(M)]
    out, own, m = sync.quantized_allreduce(
        torch.from_numpy(GRADS.copy()), SCHEME, SCHEME.init_state("cpu"),
        codec=tc, u=u, return_own=True)
    scale = np.mean(np.abs(np.asarray(jown)), axis=0)
    for w in range(M):
        assert np.all(np.abs(out.numpy() - np.asarray(jout[w]))
                      <= 1e-6 * scale + 1e-12)
    np.testing.assert_allclose(own.numpy(), np.asarray(jown), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(jown)).max())
    np.testing.assert_array_equal(m.corrupt_fraction.numpy(),
                                  np.asarray(jm.corrupt_fraction))
    np.testing.assert_array_equal(m.excluded_workers.numpy(),
                                  np.asarray(jm.excluded_workers))
    np.testing.assert_allclose(m.quant_error.numpy(),
                               np.asarray(jm.quant_error), rtol=1e-5)


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------

def test_fault_model_validation():
    with pytest.raises(ValueError, match="flip_prob"):
        FaultModel(flip_prob=1.5)
    with pytest.raises(ValueError, match="drop_prob"):
        FaultModel(drop_prob=-0.1)
    with pytest.raises(ValueError, match="delay_prob"):
        FaultModel(delay_prob=2.0)
    with pytest.raises(ValueError, match="entries"):
        FaultModel(flip_prob=(0.1, 0.2)).flip_probs(4)
    assert not FaultModel().any_wire_faults
    t = StackedTransport(M)
    assert faulty(t, None, 0) is t and faulty(t, FaultModel(), 0) is t
    assert isinstance(faulty(t, FaultModel(flip_prob=0.1), 0),
                      FaultyTransport)


def test_flip_rate_and_drop_masks_follow_their_probabilities():
    rows = [torch.zeros(50_000, dtype=torch.int32) for _ in range(M)]
    fm = FaultModel(flip_prob=(0.0, 0.01, 0.1, 0.0), seed=4)
    got = faulty(StackedTransport(M), fm, 3).all_gather(rows)
    flips = (got != 0).float().mean(1)
    assert flips[0] == 0 and flips[3] == 0
    for w, p in ((1, 0.01), (2, 0.1)):
        sd = (p * (1 - p) / 50_000) ** 0.5
        assert abs(float(flips[w]) - p) < 5 * sd
    # each flip is one bit
    nz = got[got != 0].to(torch.int64) & 0xFFFFFFFF
    assert bool(((nz & (nz - 1)) == 0).all())
    # drops and delays zero whole rows, the same rows in every collective
    ones = [torch.full((1000,), -1, dtype=torch.int32) for _ in range(M)]
    t = faulty(StackedTransport(M), FaultModel(drop_prob=1.0), 0)
    assert not bool(t.all_gather(ones).any())
    t = faulty(StackedTransport(M), FaultModel(delay_prob=1.0), 0)
    assert not bool(t.all_gather(ones).any())
    t = faulty(StackedTransport(8), FaultModel(drop_prob=0.5, seed=1), 2)
    ones8 = [torch.full((10,), -1, dtype=torch.int32) for _ in range(8)]
    a, b = t.all_gather(ones8), t.all_gather(ones8)
    dropped = ~a.bool().all(1)
    assert torch.equal(dropped, ~b.bool().all(1))
    assert torch.equal(dropped, t.drop_mask("cpu"))
    # float side-band values pass through un-faulted
    x = torch.randn(M, 10)
    assert torch.equal(t.mean_psum(x), x.mean(0))


def test_all_to_all_rows_are_corrupted_per_sender():
    fm = FaultModel(flip_prob=(0.0, 1.0, 0.0, 0.0), seed=2)
    t = faulty(StackedTransport(M), fm, 0)
    per_worker = [torch.arange(M * 6, dtype=torch.int32).view(M, 6) + 100 * w
                  for w in range(M)]
    got = t.all_to_all(per_worker)
    want = StackedTransport(M).all_to_all(per_worker)
    assert got.shape == (M, M, 6)
    changed = got != want
    assert not bool(changed[:, [0, 2, 3]].any())
    assert bool(changed[:, 1].all())
    # every receiver sees the same flips of sender 1's rows
    flips = got[:, 1] ^ want[:, 1]
    assert bool((flips == flips[0]).all())


def _run(transport, mode="all_gather", integrity=True, seed=0):
    tc = codec.make_codec(SCHEME, integrity=integrity)
    return sync.quantized_allreduce(
        torch.from_numpy(GRADS.copy()), SCHEME, SCHEME.init_state("cpu"),
        mode=mode, transport=transport, codec=tc,
        generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("mode", ["all_gather", "two_phase"])
def test_corrupted_worker_leaves_the_aggregate_exactly(mode):
    """Every word of worker 2's payload flips a bit: with integrity on,
    the aggregate is exactly that of worker 2 masked out."""
    fm = FaultModel(flip_prob=(0.0, 0.0, 1.0, 0.0), seed=3)
    out_f, m_f = _run(faulty(StackedTransport(M), fm, 0), mode)
    out_r, m_r = _run(MaskedTransport(torch.tensor([1.0, 1.0, 0.0, 1.0])),
                      mode)
    if mode == "all_gather":
        assert torch.equal(out_f, out_r)
    else:
        # worker 2 is also rank 2 of phase 2, whose corrupt shard of the
        # aggregate zero-fills; every other shard re-quantizes the same
        # mean of three workers with the same uniforms
        shard = codec.make_codec(SCHEME).plan(D, shards=M).shard_n
        keep = torch.ones(D, dtype=torch.bool)
        keep[2 * shard:3 * shard] = False
        assert torch.equal(out_f[keep], out_r[keep])
        assert not bool(out_f[~keep].any())
    # one worker's buckets of the (all_gather) or each (two_phase) hop
    np.testing.assert_allclose(m_f.corrupt_fraction.numpy(), 0.25)
    np.testing.assert_array_equal(m_f.excluded_workers.numpy(), 1.0)
    assert float(m_r.excluded_workers[0]) == 0.0


def test_dropped_payloads_give_a_zero_aggregate():
    fm = FaultModel(drop_prob=1.0, seed=3)
    for mode in ("all_gather", "two_phase"):
        out, m = _run(faulty(StackedTransport(M), fm, 0), mode)
        assert not bool(out.any())
        assert float(m.excluded_workers[0]) == M


def test_fault_free_integrity_on_matches_off():
    out_on, m_on = _run(StackedTransport(M))
    out_off, _ = _run(StackedTransport(M), integrity=False)
    torch.testing.assert_close(out_on, out_off, rtol=1e-5, atol=1e-9)
    assert float(m_on.corrupt_fraction.max()) == 0.0
    assert float(m_on.excluded_workers.max()) == 0.0


@pytest.mark.parametrize("mode", ["all_gather", "two_phase"])
def test_faulty_wire_stays_finite_with_integrity(mode):
    fm = FaultModel(flip_prob=0.02, seed=5)
    out, m = _run(faulty(StackedTransport(M), fm, 0), mode)
    assert bool(torch.isfinite(out).all())
    assert 0.0 < float(m.corrupt_fraction[0]) < 1.0


def test_injection_deterministic_in_seed_and_step():
    fm = FaultModel(flip_prob=0.01, drop_prob=0.05, seed=9)
    a = _run(faulty(StackedTransport(M), fm, 4))[0]
    b = _run(faulty(StackedTransport(M), fm, 4))[0]
    c = _run(faulty(StackedTransport(M), fm, 5))[0]
    assert torch.equal(a, b) and not torch.equal(a, c)

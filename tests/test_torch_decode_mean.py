"""The fused decode-and-average of the wire (``dequantize_mean``) against
the reference package, against the port's own decode-then-mean, and its
memory on the meta device.

The reference decodes the M gathered streams (``codec.decode``) and then
averages them (``transport.mean_workers``, or with integrity words
``mean_workers_bucketed``).  The port's plain version
``kernels.ref.dequantize_mean_ref`` and each codec's ``decode_mean`` must
hold against that on the same words (made by the reference's encode of
numpy gradients): within rtol 1e-6 of the terms' mean magnitude, the
tolerance ``test_torch_codec_sync.py`` states (the same decoded terms;
XLA may add them in another order).

On the CPU the new ``quantized_allreduce`` must equal the old
composition, ``codec.decode`` then the transport's mean (the default
``GradientCodec.decode_mean``), bit for bit: the plain mean sums in
worker order from 0 and divides, which ATen's CPU ``mean(0)`` does over
a row whose length is a multiple of 32 (every payload here: buckets of a
multiple of 4 in tiles of 8; at M >= 5 its scalar tail adds in another
order), and the masked means repeat ``_weighted_sum``'s products and
adds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.codec import WirePayload as JPayload
from repro.core.codec import codec_for_scheme as jcodec_for_scheme
from repro.core.schemes import QuantScheme as JScheme
from repro.dist import transport as jtransport
from repro_torch.core import packing
from repro_torch.core.codec import (
    GradientCodec, MixedWidthCodec, UniformCodec, WirePayload,
    codec_for_scheme, make_codec)
from repro_torch.core.quantize import code_dtype
from repro_torch.core.schemes import QuantScheme
from repro_torch.dist import faults, sync
from repro_torch.dist.transport import MaskedTransport, StackedTransport
from repro_torch.kernels import ops, ref
from repro_torch.launch import op_cost

# one thread: xdist workers that each take every core starve one another
torch.set_num_threads(1)

D, BS = 1500, 128          # 12 buckets of data, padded to 16


def _grads(M, d, seed=0):
    rng = np.random.default_rng(seed)
    scale = np.exp(rng.standard_normal((M, 1)))
    return (rng.standard_normal((M, d)) * 1e-2 * scale).astype(np.float32)


_REFERENCE = {}


def _reference(M, bits):
    """The reference's M payloads of numpy gradients, and one jitted
    program that decodes them and takes the three means (plain, masked by
    ``active``, bucketed by ``valid``): compiled once per (M, bits)."""
    if (M, bits) in _REFERENCE:
        return _REFERENCE[M, bits]
    jscheme = JScheme(bits=bits, bucket_size=BS)
    jc = jcodec_for_scheme(jscheme)
    plan = jc.plan(D)
    levels = jscheme.init_levels()
    key = jax.random.PRNGKey(M * 10 + bits)
    grads = jnp.asarray(_grads(M, D, seed=M))

    @jax.jit
    def encode(g):
        return [jc.encode(jc.bucketize(g[m], plan), levels,
                          jax.random.fold_in(key, m), plan, use_pallas=False)
                for m in range(M)]

    @jax.jit
    def means(words, norm_words, active, valid):
        vals = jc.decode(JPayload(words, norm_words), levels, plan,
                         use_pallas=False)
        return (vals, jtransport.MeshTransport(()).mean_workers(vals),
                jtransport.MaskedTransport((), active).mean_workers(vals),
                jtransport.MaskedTransport((), active).mean_workers_bucketed(
                    vals, valid, BS))

    pays = encode(grads)
    words = np.stack([np.asarray(p.words) for p in pays])
    nwords = np.stack([np.asarray(p.norm_words) for p in pays])
    _REFERENCE[M, bits] = (plan, np.asarray(levels), words, nwords, means)
    return _REFERENCE[M, bits]


def _case(M, bits, mode):
    """(port payload, levels, active, valid, reference mean, the decoded
    terms) of one case; an invalid bucket's norm word is NaN."""
    plan, levels, words, nwords, means = _reference(M, bits)
    rng = np.random.default_rng(M + 100 * bits)
    active = np.ones(M, np.float32)
    valid = np.ones((M, plan.nb), bool)
    if mode != "plain" and M > 1:
        active[rng.integers(M)] = 0.0
    if mode == "invalid":
        valid = rng.random((M, plan.nb)) < 0.7
        valid[0, 0] = False
        nwords = nwords.copy()
        nwords[0, 0] = np.float32(np.nan).view(np.uint32)
    vals, plain, masked, bucketed = means(
        jnp.asarray(words), jnp.asarray(nwords), jnp.asarray(active),
        jnp.asarray(valid))
    want = {"plain": plain, "masked": masked, "invalid": bucketed}[mode]
    payload = WirePayload(torch.from_numpy(words.view(np.int32)),
                          torch.from_numpy(nwords.view(np.int32)))
    terms = np.where(valid.repeat(BS, axis=1), np.asarray(vals), 0.0)
    return (plan, payload, torch.from_numpy(levels.copy()),
            torch.from_numpy(active), torch.from_numpy(valid),
            np.asarray(want), terms)


def _transport(M, mode, active):
    return StackedTransport(M) if mode == "plain" else MaskedTransport(active)


@pytest.mark.parametrize("mode", ["plain", "masked", "invalid"])
@pytest.mark.parametrize("bits", [3, 8])
@pytest.mark.parametrize("M", [1, 2, 3, 4, 5])
def test_ref_matches_the_reference_decode_then_mean(M, bits, mode):
    plan, payload, levels, active, valid, want, terms = _case(M, bits, mode)
    L = levels.shape[0]
    codes = torch.empty((M, plan.nb, BS), dtype=code_dtype(L))
    for m, w in enumerate(payload.words):
        packing.unpack_signed(w, plan.n, L, out=codes[m])
    assert codes.dtype == (torch.int8 if bits < 8 else torch.int16)
    norms = torch.stack([packing.unpack_norms(w, plan.nb)
                         for w in payload.norm_words])
    t = _transport(M, mode, active)
    checked = valid if mode == "invalid" else None
    got = ref.dequantize_mean_ref(codes, norms, levels,
                                  t.mean_weights(checked), checked)
    dec = codec_for_scheme(QuantScheme(bits=bits, bucket_size=BS)).decode_mean(
        payload, levels, plan, t)
    scale = np.mean(np.abs(terms), axis=0)
    # the codec's own validity comes from integrity words, which these
    # payloads lack: its decode_mean is held to the unmasked means
    for out in [got.reshape(-1)] + [dec.mean] * (mode != "invalid"):
        err = np.abs(out.numpy() - want)
        assert np.all(err <= 1e-6 * scale + 1e-12), err.max()
    assert dec.valid is None
    # each stream's own values: the reference's decode, exactly
    vals = np.asarray(_reference(M, bits)[4](
        jnp.asarray(payload.words.numpy().view(np.uint32)),
        jnp.asarray(payload.norm_words.numpy().view(np.uint32)),
        jnp.asarray(active.numpy()), jnp.asarray(valid.numpy()))[0])
    for m in range(M):
        np.testing.assert_array_equal(dec.row(m).numpy(), vals[m])


def _old_decode_mean(monkeypatch):
    """Every codec's ``decode_mean`` as it was: decode, then the
    transport's mean."""
    for cls in (UniformCodec, MixedWidthCodec):
        monkeypatch.setattr(cls, "decode_mean", GradientCodec.decode_mean)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _allreduce(M, mode, codec, transport, seed):
    scheme = QuantScheme(bits=3, bucket_size=BS)
    grads = torch.from_numpy(_grads(M, D, seed=seed))
    g = [torch.Generator().manual_seed(seed * 10 + w) for w in range(M)]
    return sync.quantized_allreduce(
        grads, scheme, scheme.init_state("cpu"), mode=mode,
        transport=transport, codec=codec, generator=g, return_own=True)


CODECS = {"uniform": {}, "integrity": {"integrity": True},
          "entropy": {"kind": "entropy", "integrity": True},
          "mixed": {"kind": "mixed_width"}}
TRANSPORTS = {"stacked": lambda M: StackedTransport(M),
              "masked": lambda M: MaskedTransport(
                  torch.tensor([1.0, 0.0, 1.0, 1.0][:M])),
              "faulty": lambda M: faults.FaultyTransport(
                  StackedTransport(M), faults.FaultModel(flip_prob=2e-3),
                  seed=3)}


@pytest.mark.parametrize("transport", sorted(TRANSPORTS))
@pytest.mark.parametrize("codec", sorted(CODECS))
@pytest.mark.parametrize("mode", ["all_gather", "two_phase"])
@pytest.mark.parametrize("M", [3, 4])
def test_allreduce_equals_the_old_composition_bit_for_bit(
        M, mode, codec, transport, monkeypatch):
    kw = dict(CODECS[codec])
    tc = make_codec(QuantScheme(bits=3, bucket_size=BS), kw.pop("kind",
                                                                "uniform"),
                    **kw)
    new = _allreduce(M, mode, tc, TRANSPORTS[transport](M), M)
    _old_decode_mean(monkeypatch)
    old = _allreduce(M, mode, tc, TRANSPORTS[transport](M), M)
    for a, b in zip(new[:2], old[:2]):      # aggregate, own round trips
        assert torch.equal(_bits(a), _bits(b))
    for f in ("quant_error", "corrupt_fraction", "excluded_workers"):
        assert torch.equal(_bits(getattr(new[2], f)),
                           _bits(getattr(old[2], f))), f
    assert new[2].comm_bits_per_coord == old[2].comm_bits_per_coord


class _NoMeans(StackedTransport):
    """A stacked transport that refuses to average decoded streams."""

    def mean_workers(self, stacked):
        raise AssertionError("decoded streams averaged after the decode")

    def mean_workers_bucketed(self, stacked, valid, bucket_size):
        raise AssertionError("decoded streams averaged after the decode")


@pytest.mark.parametrize("codec", sorted(CODECS))
@pytest.mark.parametrize("mode", ["all_gather", "two_phase"])
def test_the_wire_decodes_and_averages_in_one_pass(mode, codec, monkeypatch):
    """all_gather and two_phase's phase 1 go through one
    ``dequantize_mean`` a decode (a width group's, for mixed widths), and
    ``dequantize`` only ever sees one stream's rows."""
    M = 4
    kw = dict(CODECS[codec])
    tc = make_codec(QuantScheme(bits=3, bucket_size=BS), kw.pop("kind",
                                                                "uniform"),
                    **kw)
    calls = {"mean": 0, "rows": []}
    mean_op, deq_op = ops.dequantize_mean_op, ops.dequantize_op

    def spy_mean(*a, **k):
        calls["mean"] += 1
        return mean_op(*a, **k)

    def spy_deq(codes, *a, **k):
        calls["rows"].append(codes.shape[0])
        return deq_op(codes, *a, **k)

    monkeypatch.setattr(ops, "dequantize_mean_op", spy_mean)
    monkeypatch.setattr(ops, "dequantize_op", spy_deq)
    _allreduce(M, mode, tc, _NoMeans(M), 1)
    nb = tc.plan(D, shards=M if mode == "two_phase" else 1).nb
    groups = 2 if codec == "mixed" else 1
    assert calls["mean"] == groups * (1 if mode == "all_gather" else M)
    assert max(calls["rows"]) <= nb


class _DecodeWindow:
    """A stage clock that restarts ``CostMode``'s peak when the gather
    ends, and keeps the live bytes of the last mark before it (the
    gradient rows and the local payloads)."""

    def __init__(self, mode):
        self.mode, self.before = mode, None

    def mark(self, stage):
        if stage == "collective":
            self.mode.reset()
        elif stage == "pack":
            self.before = self.mode.live_bytes


def test_all_gather_decode_holds_no_m_by_d_float32_on_meta(monkeypatch):
    """The peak live bytes of an all_gather sync's decode at M = 8 and
    d = 2^20 on the meta device, from the end of the encode (less the
    gradient rows and local payloads live then) to the end of the sync:
    the gathered words, the int8 codes, the mean and one own row with its
    error's temporaries (~1.4 M d + 20 d bytes) stay below M d float32;
    decoding every stream to float32 first held ~8.4 M d.  The packing
    chunk is cut to 2^16 symbols: a chunk's int64 temporaries (~32 bytes a
    symbol, bounded by the chunk at any d) would otherwise span the whole
    stream at this d."""
    monkeypatch.setattr(packing, "CHUNK_SYMBOLS", 1 << 16)
    M, d = 8, 1 << 20
    scheme = QuantScheme(bits=3, bucket_size=8192)
    state = scheme.init_state("cpu")
    state = state._replace(levels=state.levels.to("meta"))
    flats = torch.empty((M, d), device="meta")
    with op_cost.CostMode(pinned=(flats,)) as mode:
        clock = _DecodeWindow(mode)
        sync.quantized_allreduce(flats, scheme, state, clock=clock)
    held = mode.cost.peak_bytes - clock.before
    print(f"decode held {held / (M * d):.3f} M d bytes")
    assert 1.375 * M * d < held < M * d * 4


def test_mean_weights_follow_each_transport():
    M, nb = 3, 5
    valid = torch.rand(M, nb, generator=torch.Generator().manual_seed(0)) < .6
    assert StackedTransport(M).mean_weights() is None
    active = torch.tensor([1.0, 0.0, 1.0])
    masked = MaskedTransport(active)
    assert torch.equal(masked.mean_weights(), masked.weights())
    for t in (StackedTransport(M), masked):
        a = t.active_vector()[:, None] * valid.float()
        assert torch.equal(t.mean_weights(valid),
                           a / torch.clamp(a.sum(0), min=1.0))
    faulty = faults.FaultyTransport(masked, faults.FaultModel(), seed=0)
    assert torch.equal(faulty.mean_weights(), masked.weights())


@pytest.mark.parametrize("bits", [1, 3, 7, 8])
def test_unpack_unbiases_into_the_code_width(bits):
    L = 2 ** bits
    g = torch.Generator().manual_seed(bits)
    codes = torch.randint(-(L - 1), L, (999,), generator=g)
    words = packing.pack_signed(codes, L)
    got = torch.empty(999, dtype=code_dtype(L))
    packing.unpack_signed(words, 999, L, out=got)
    assert torch.equal(got.long(), codes)
    assert torch.equal(packing.unpack_signed(words, 999, L),
                       packing.unbias_codes(packing.unpack(
                           words, 999, packing.wire_bits_for(L)), L))


def test_meta_operator_gives_the_shape_and_is_charged_its_bytes():
    M, nb, bs = 4, 6, 64
    codes = torch.empty((M, nb, bs), dtype=torch.int8, device="meta")
    norms = torch.empty((M, nb), device="meta")
    levels = torch.empty(8, device="meta")
    w = torch.empty((M, nb), device="meta")
    valid = torch.empty((M, nb), dtype=torch.bool, device="meta")
    cost = op_cost.analyze_fn(
        lambda *a: ops.dequantize_mean_op(*a), codes, norms, levels, w, valid)
    assert cost.hbm_bytes == (M * nb * bs + 4 * M * nb + 4 * 8 + 4 * M * nb
                              + M * nb + 4 * nb * bs)
    out = ops.dequantize_mean_op(codes, norms, levels)
    assert out.shape == (nb, bs) and out.dtype == torch.float32
    with pytest.raises(ValueError, match="validity needs weights"):
        ops.dequantize_mean_op(codes, norms, levels, None, valid)

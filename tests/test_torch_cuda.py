"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: they skip without a CUDA device.  This file
imports neither JAX nor the reference package, so it runs where only
PyTorch is installed:

    python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: norms rtol 1e-5 and stats rtol 1e-5 (float32 sums of up to
65536 terms in another order); dequantized values exact (one rounding in
the same order), and dequantize and the fused decode-and-average
dequantize_mean equal to their plain versions as bit patterns (the sign
of zero included: the same products and sums in the same order); codes
exact except off by one where the plain version's |u - rho| < 1e-5 (a
last-ulp norm difference).

quantize and bucket_stats lay a bucket out in registers, in shared
memory or read twice (``kernels/cuda.py::bucket_launch``); the layout
tests below reach each one by bucket size and pointer alignment.

The entropy-coded and mixed-width codecs run the same kernels at every
width 1..8 (the mixed width's groups on resampled grids of 2..256
levels): their words on the card equal the CPU's wherever the codes
agree, and the card decodes the CPU's words exactly.

The model's attention is deterministic: two backward passes at 1024
tokens give bit-equal gradients, as the entry points run and under
``torch.use_deterministic_algorithms`` (in a process of its own, with
``CUBLAS_WORKSPACE_CONFIG`` set before CUDA starts).  ``repro_torch.core``'s
encode and decode launch the kernels on card tensors.

Data parallelism across processes: qwen3-0.6b's SMOKE config through the
launcher in 2 gloo ranks sharing the card (all_gather and two_phase) and
in one NCCL rank, each bit-equal to the stacked workers of the same M on
the card (losses and the final parameters' sha256).

Rematerialization: every ``remat`` mode's gradients equal ``"none"``'s
bit for bit on the card.  FSDP: the quantized reduce-scatter on the card
against the CPU (every codec, with error feedback), launching the CUDA
kernels, and a stacked FSDP trainer's steps on the card against the CPU.

Serving: a SMOKE config's prefill and decode steps on the card against
the CPU (logits and caches within 1e-5 of their largest entry, 5e-5 for
jamba) and twice bit-equal; RWKV6 at the init's decays, card and CPU
against float64; a sliding window's ring overwritten by decode steps,
against the card's own full forward.  These share ``chip_smoke.py``'s
serving helpers.

The dry run: the meta device's peak of a SMOKE train step, counted by
``launch.op_cost``, within 10% of the card's for the same step.

Tensor parallelism: ``psum_tp`` over an NCCL group of one rank on the
card is the identity and the model's loss and gradient equal the tp = 1
path's bit for bit; a model group of two gloo ranks sharing the card
against the same two ranks on the CPU (loss rtol 1e-6, gradients within
1e-5 of their largest entry, ``psum_tp`` and its backward exact).
"""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.compress import SparseCodec
from repro_torch.core import levels as lv
from repro_torch.core.codec import codec_for_scheme, make_codec
from repro_torch.core.schemes import QuantScheme
from repro_torch.dist import sync
from repro_torch.kernels import cuda as kcuda
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bucket_stats import bucket_stats_cuda
from repro_torch.kernels.quantize import quantize_cuda
from repro_torch.launch import train

# one thread: xdist workers that each take every core starve one another
torch.set_num_threads(1)

GRIDS = {"uniform3": lambda d: lv.uniform_levels(3, device=d),
         "exp4": lambda d: lv.exp_levels(4, device=d),
         "ternary": lambda d: lv.ternary_levels(device=d),
         "uniform8": lambda d: lv.uniform_levels(8, device=d)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [100, 128, 1024, 8192])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_kernels_match_plain_versions(dev, bs, grid):
    g = torch.Generator(device=dev).manual_seed(bs)
    levels = GRIDS[grid](dev)
    before = dict(kcuda.LAUNCHES)
    for norm in ("l2", "linf"):
        for dt in (torch.float32, torch.bfloat16):
            vb = (torch.randn(24, bs, generator=g, device=dev) * 0.1).to(dt)
            u = torch.rand(24, bs, generator=g, device=dev)
            c1, n1 = ops.quantize_op(vb, u, levels, norm_type=norm)
            c2, n2 = ref.quantize_ref(vb, u, levels, norm)
            assert c1.dtype == c2.dtype
            torch.testing.assert_close(n1, n2, rtol=1e-5, atol=0)
            ref.code_mismatches(c1, c2, vb, u, n2, levels)
            for c in (c1, c1.to(torch.int32)):
                assert torch.equal(ops.dequantize_op(c, n1, levels),
                                   ref.dequantize_ref(c, n1, levels))
            # two streams: these codes and the same rows reversed
            cm, nm = (torch.stack([c1, c1.flip(0)]),
                      torch.stack([n1, n1.flip(0)]))
            assert torch.equal(
                _bits(ops.dequantize_mean_op(cm, nm, levels)),
                _bits(ref.dequantize_mean_ref(cm, nm, levels)))
            for a, b in zip(ops.bucket_stats_op(vb, norm_type=norm),
                            ref.bucket_stats_ref(vb, norm)):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    torch.cuda.synchronize()
    launched = {k: kcuda.LAUNCHES[k] - before.get(k, 0) for k in kcuda.KERNELS}
    assert launched == {"quantize": 4, "dequantize": 8, "dequantize_mean": 4,
                        "bucket_stats": 4}


def _bits(x: torch.Tensor) -> torch.Tensor:
    """A float32 tensor's bit patterns: equal only where the values and
    the signs of zero are."""
    return x.contiguous().view(torch.int32)


def _wild_codes(dev, shape, dtype, L, g):
    """Codes of ``dtype`` over ``L`` levels, about 5% of them outside the
    table (|c| in [L, 2L)) and every 101st the type's most negative
    value."""
    codes = torch.randint(-(L - 1), L, shape, generator=g, device=dev)
    outside = torch.randint(L, 2 * L, shape, generator=g, device=dev) * (
        1 - 2 * torch.randint(0, 2, shape, generator=g, device=dev))
    wild = torch.rand(shape, generator=g, device=dev) < 0.05
    codes = torch.where(wild, outside, codes).to(dtype)
    codes.view(-1)[::101] = torch.iinfo(dtype).min
    return codes


def _grid_for(dtype, dev):
    """int16 codes come from 8-bit grids, the others from 3-bit ones."""
    return lv.uniform_levels(8 if dtype == torch.int16 else 3, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [100, 128, 512, 1024, 8192])
@pytest.mark.parametrize("code_dtype", [torch.int8, torch.int16, torch.int32])
def test_dequantize_equals_its_plain_version_as_bit_patterns(dev, code_dtype,
                                                             bs):
    """The persistent-grid dequantize at an odd bucket count, on row
    slices at odd offsets (off 16-byte alignment unless the rows before
    are whole vectors) and on a buffer one code off alignment, with codes
    outside the table and zero norms (a negative code then gives -0)."""
    g = torch.Generator(device=dev).manual_seed(bs)
    levels = _grid_for(code_dtype, dev)
    L, nb = levels.numel(), 37
    flat = _wild_codes(dev, ((nb + 8) * bs + 1,), code_dtype, L, g)
    norms = torch.rand(nb + 8, generator=g, device=dev)
    norms[::5] = 0.0
    codes = flat[:(nb + 8) * bs].view(nb + 8, bs)
    before = kcuda.LAUNCHES["dequantize"]
    cases = [(codes[:nb], norms[:nb]),
             (flat[1:nb * bs + 1].view(nb, bs), norms[:nb])]
    cases += [(codes[r:r + nb], norms[r:r + nb]) for r in (1, 3, 7)]
    for c, n in cases:
        got = ops.dequantize_op(c, n, levels)
        assert torch.equal(_bits(got), _bits(ref.dequantize_ref(c, n, levels)))
    torch.cuda.synchronize()
    assert kcuda.LAUNCHES["dequantize"] == before + len(cases)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["plain", "weights", "bucket_weights",
                                  "masked"])
@pytest.mark.parametrize("M", [1, 2, 3, 4, 5])
def test_dequantize_mean_equals_its_plain_version_as_bit_patterns(dev, M,
                                                                  mode):
    """The fused decode-and-average of M streams in each mode: the plain
    mean (sum from 0, then divide), (M,) and (M, nb) weights, and weights
    with invalid buckets (one of which decodes to NaN), over int8, int16
    and int32 codes at whole and ragged chunks, against the plain version
    on the card, bit for bit."""
    g = torch.Generator(device=dev).manual_seed(M)
    cases = ((torch.int8, 128), (torch.int8, 100), (torch.int16, 512),
             (torch.int32, 100), (torch.int32, 8192))
    before = kcuda.LAUNCHES["dequantize_mean"]
    for dtype, bs in cases:
        levels = _grid_for(dtype, dev)
        nb = 19
        codes = _wild_codes(dev, (M, nb, bs), dtype, levels.numel(), g)
        norms = torch.rand(M, nb, generator=g, device=dev)
        norms[:, ::4] = 0.0
        weights = valid = None
        if mode == "weights":
            weights = torch.rand(M, generator=g, device=dev)
        elif mode != "plain":
            weights = torch.rand(M, nb, generator=g, device=dev)
        if mode == "masked":
            valid = torch.rand(M, nb, generator=g, device=dev) < 0.7
            valid[0, 1] = False
            norms[0, 1] = float("nan")
        got = ops.dequantize_mean_op(codes, norms, levels, weights, valid)
        want = ref.dequantize_mean_ref(codes, norms, levels, weights, valid)
        assert got.shape == (nb, bs)
        assert torch.equal(_bits(got), _bits(want)), (dtype, bs)
    torch.cuda.synchronize()
    assert kcuda.LAUNCHES["dequantize_mean"] == before + len(cases)


@pytest.mark.cuda
@pytest.mark.parametrize("code_dtype", [torch.int8, torch.int32])
def test_dequantize_outside_the_table_gives_zero(dev, code_dtype):
    levels = lv.uniform_levels(3, device=dev)
    L = levels.numel()
    g = torch.Generator(device=dev).manual_seed(0)
    codes = torch.randint(-(L + 7), L + 8, (16, 1024), generator=g,
                          device=dev).to(code_dtype)
    norms = torch.rand(16, generator=g, device=dev) + 0.1
    got = ops.dequantize_op(codes, norms, levels)
    assert torch.equal(got, ref.dequantize_ref(codes, norms, levels))
    assert not got[codes.abs() >= L].any()


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    levels = lv.uniform_levels(3, device=dev)
    vb = torch.randn(8, 256, device=dev)
    u = torch.rand(8, 256, device=dev)
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.quantize_op(vb, u.cpu(), levels)
    with pytest.raises(ValueError, match="f32 or bf16"):
        ops.quantize_op(vb.half(), u, levels)
    with pytest.raises(ValueError, match="contiguous"):
        ops.bucket_stats_op(vb.t().contiguous().t())
    with pytest.raises(ValueError, match="norms"):
        ops.dequantize_op(torch.zeros(8, 256, dtype=torch.int8, device=dev),
                          torch.ones(7, device=dev), levels)
    codes = torch.zeros(2, 8, 256, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="validity needs weights"):
        ops.dequantize_mean_op(codes, torch.ones(2, 8, device=dev), levels,
                               None, torch.ones(2, 8, dtype=torch.bool,
                                                device=dev))
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.dequantize_mean_op(codes, torch.ones(2, 8), levels)


@pytest.mark.cuda
def test_allreduce_on_card_matches_cpu(dev):
    M, d, bs = 4, 50_000, 1024
    scheme = QuantScheme(bits=3, bucket_size=bs)
    plan = codec_for_scheme(scheme).plan(d)
    g = torch.Generator().manual_seed(0)
    grads = torch.randn(M, d, generator=g) * 1e-2
    u = [torch.rand(plan.nb, bs, generator=g) for _ in range(M)]
    cpu, own, _ = sync.quantized_allreduce(grads, scheme,
                                           scheme.init_state("cpu"),
                                           u=u, return_own=True)
    gpu, _ = sync.quantized_allreduce(grads.to(dev), scheme,
                                      scheme.init_state(dev),
                                      u=[x.to(dev) for x in u])
    err = (gpu.cpu() - cpu).abs()
    close = err <= 1e-6 * own.abs().mean(0) + 1e-12
    assert float(close.float().mean()) >= 0.999


def _values(dev, nb, bs, dt, offset=0, seed=0):
    """(nb, bs) values in ``dt`` starting ``offset`` elements into a flat
    buffer (offset 1 leaves the pointer off 16-byte alignment), with
    bucket 0 all zero, and their uniforms."""
    g = torch.Generator(device=dev).manual_seed(seed)
    flat = (torch.randn(nb * bs + offset, generator=g, device=dev)
            * 0.1).to(dt)
    vb = flat[offset:].view(nb, bs)
    vb[0] = 0
    return vb, torch.rand(nb, bs, generator=g, device=dev)


def _check_layout(vb, u, levels, norm):
    """quantize and bucket_stats, in the layout the wrappers pick, against
    the plain versions; returns the layout."""
    want = kcuda.bucket_launch(vb.shape[1], vb.element_size(),
                               (vb.data_ptr(), u.data_ptr(), 0))
    before = dict(kcuda.LAYOUTS)
    c1, n1 = quantize_cuda(vb, u, levels, norm)
    c2, n2 = ref.quantize_ref(vb, u, levels, norm)
    assert c1.dtype == c2.dtype
    torch.testing.assert_close(n1, n2, rtol=1e-5, atol=0)
    ref.code_mismatches(c1, c2, vb, u, n2, levels)
    for a, b in zip(bucket_stats_cuda(vb, norm),
                    ref.bucket_stats_ref(vb, norm)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    torch.cuda.synchronize()
    for k in ("quantize", "bucket_stats"):
        key = f"{k}/{want.layout}"
        assert kcuda.LAYOUTS[key] == before.get(key, 0) + 1
    assert not c1[0].any() and not n1[0]  # the all-zero bucket
    return want.layout


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [1024, 8192])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_unaligned_base_pointer_is_staged_in_shared_memory(dev, bs, dt):
    vb, u = _values(dev, 24, bs, dt, offset=1)
    assert vb.is_contiguous() and vb.data_ptr() % 16
    levels = lv.uniform_levels(3, device=dev)
    assert _check_layout(vb, u, levels, "l2") == "smem"


@pytest.mark.cuda
@pytest.mark.parametrize("bs,layout", [(4097, "smem"), (16384, "smem"),
                                       (65536, "stream")])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_odd_and_large_buckets(dev, bs, layout, dt):
    """4097 is no multiple of a vector; 16384 is beyond the register
    shapes; 65536 f32 does not fit shared memory, and bf16 does."""
    vb, u = _values(dev, 12, bs, dt)
    levels = lv.exp_levels(4, device=dev)
    if bs == 65536 and dt == torch.bfloat16:
        layout = "smem"
    assert _check_layout(vb, u, levels, "l2") == layout


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [1024, 8192])
def test_bf16_values_int16_codes_linf_norm(dev, bs):
    vb, u = _values(dev, 24, bs, torch.bfloat16)
    levels = lv.uniform_levels(8, device=dev)
    assert _check_layout(vb, u, levels, "linf") == "regs"
    codes, _ = ops.quantize_op(vb, u, levels, norm_type="linf")
    assert codes.dtype == torch.int16 and int(codes.abs().max()) > 127


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [1024, 8192])
def test_all_zero_buckets_give_zero_codes_and_stats(dev, bs):
    vb = torch.zeros(16, bs, device=dev)
    u = torch.rand(16, bs, device=dev)
    for norm in ("l2", "linf"):
        codes, norms = ops.quantize_op(vb, u, lv.uniform_levels(3, device=dev),
                                       norm_type=norm)
        assert not codes.any() and not norms.any()
        for x in ops.bucket_stats_op(vb, norm_type=norm):
            assert not x.any()


@pytest.mark.cuda
@pytest.mark.parametrize("offset,layout", [(0, "regs"), (1, "smem")])
def test_every_layout_of_a_production_bucket(dev, offset, layout):
    """Both layouts a bucket of 8192 takes, registers when aligned and
    shared memory when not, over 3000 buckets (a grid of several waves)
    with 3-bit and 8-bit grids."""
    vb, u = _values(dev, 3000, 8192, torch.float32, offset=offset)
    levels = lv.exp_levels(3, device=dev)
    assert _check_layout(vb, u, levels, "l2") == layout
    vb, u = _values(dev, 40, 8192, torch.bfloat16, offset=offset, seed=1)
    levels = lv.uniform_levels(8, device=dev)
    assert _check_layout(vb, u, levels, "linf") == layout


def _slice_case(dev, case):
    """The inputs the two_phase and topk paths give the kernels: a rank's
    shard mean for the 8-bit L-inf phase 2, and the kept values of a
    top-k selection, rows of 1927 f32 (7708 bytes, so every row but the
    first starts off 16-byte alignment)."""
    if case == "phase2":
        vb, u = _values(dev, 40, 8192, torch.float32)
        return vb, u, lv.uniform_levels(8, device=dev), "linf", "regs"
    vb, _ = _values(dev, 48, 8192, torch.float32, seed=2)
    vb[1, :100] = 0.25                    # ties among the kept magnitudes
    sel, idx = SparseCodec(bucket_size=8192, k=1927).select(vb)
    assert sel.shape == (48, 1927) and sel.is_contiguous()
    assert bool((idx[0] == torch.arange(1927, device=dev)).all())
    u = torch.rand(sel.shape, generator=torch.Generator(
        device=dev).manual_seed(3), device=dev)
    return sel, u, lv.uniform_levels(3, device=dev), "l2", "smem"


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["phase2", "topk"])
def test_slice_kernel_modes(dev, case):
    """quantize, bucket_stats and dequantize at the modes the two_phase
    and topk paths give them, against the plain versions."""
    vb, u, levels, norm, layout = _slice_case(dev, case)
    assert _check_layout(vb, u, levels, norm) == layout
    codes, norms = ops.quantize_op(vb, u, levels, norm_type=norm)
    assert codes.dtype == (torch.int16 if levels.numel() > 128
                           else torch.int8)
    for c in (codes, codes.to(torch.int32)):
        assert torch.equal(ops.dequantize_op(c, norms, levels),
                           ref.dequantize_ref(c, norms, levels))


def _codec_on_both(codec, scheme, dev, d, shards, seed):
    """One gradient encoded by ``codec`` on the CPU and on the card with
    the same uniforms: (cpu payload, card payload, per-bucket mask of the
    codes that agree, the plan, the levels on each device)."""
    plan = codec.plan(d, shards=shards)
    g = torch.Generator().manual_seed(seed)
    flat = torch.randn(d, generator=g) * 1e-2
    u = torch.rand(plan.nb, plan.bucket_size, generator=g)
    pays, codes = [], []
    for where in ("cpu", dev):
        lvs = scheme.init_levels(where)
        vb = codec.bucketize(flat.to(where), plan)
        pays.append(codec.encode(vb, lvs, plan=plan, u=u.to(where)))
        codes.append(ops.quantize_op(vb, u.to(where), lvs,
                                     norm_type=codec.norm_type)[0].cpu())
    same = (codes[0] == codes[1]).all(dim=1)
    return pays[0], pays[1], same, plan


def _on(payload, dev):
    return type(payload)(*(x.to(dev) for x in payload))


@pytest.mark.cuda
@pytest.mark.parametrize("bits", range(1, 9))
def test_entropy_codec_on_card_matches_cpu(dev, bits):
    """Header, region and checksum words equal wherever a bucket's codes
    agree (a last-ulp norm can move a code at a rounding tie); the card
    decodes the CPU's words to the CPU's values exactly, and its own words
    to its uniform decode."""
    scheme = QuantScheme(name="alq", bits=bits, bucket_size=1024)
    codec = make_codec(scheme, "entropy", integrity=True)
    cpu, card, same, plan = _codec_on_both(codec, scheme, dev, 40_000, 4,
                                           bits)
    assert float(same.float().mean()) >= 0.99
    snb, cap = plan.shard_nb, codec.cap_words
    same = same.view(4, snb)
    w0, w1 = cpu.words, card.words.cpu()
    assert bool((w0[:, snb:2 * snb] == w1[:, snb:2 * snb])[same].all())
    assert bool((w0[:, 2 * snb:].view(4, snb, cap)
                 == w1[:, 2 * snb:].view(4, snb, cap)).all(2)[same].all())
    nsame = same & (cpu.norm_words == card.norm_words.cpu())
    assert bool((w0[:, :snb] == w1[:, :snb])[nsame].all())
    lv_cpu, lv_dev = scheme.init_levels("cpu"), scheme.init_levels(dev)
    vals, valid = codec.decode_checked(_on(cpu, dev), lv_dev, plan)
    assert bool(valid.all())
    assert torch.equal(vals.cpu(), codec.decode(cpu, lv_cpu, plan))
    assert codec.measured_bits_per_coord(card, plan) == \
        codec.measured_bits_per_coord(_on(card, "cpu"), plan)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", range(1, 9))
def test_mixed_width_codec_on_card_matches_cpu(dev, bits):
    """Groups of width ``bits`` beside 3-bit ones: words equal wherever
    codes agree, and the card decodes the CPU's words to the CPU's values
    exactly, diagonally and per segment."""
    scheme = QuantScheme(name="alq", bits=3, bucket_size=1024)
    codec = make_codec(scheme, "mixed_width", (bits, 3, bits))
    cpu, card, same, plan = _codec_on_both(codec, scheme, dev, 40_000, 4,
                                           10 + bits)
    assert float(same.float().mean()) >= 0.99
    if bool(same.all()):
        assert torch.equal(cpu.words, card.words.cpu())
    lv_cpu, lv_dev = scheme.init_levels("cpu"), scheme.init_levels(dev)
    want = codec.decode(cpu, lv_cpu, plan)
    assert torch.equal(codec.decode(_on(cpu, dev), lv_dev, plan).cpu(), want)
    for s in range(4):
        one = type(cpu)(cpu.words[s][None], cpu.norm_words[s][None])
        got = codec.decode(_on(one, dev), lv_dev, plan, shard=s)
        assert torch.equal(got[0].cpu(), want[s])


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_scenario_buckets_of_512_in_shared_memory(dev, dt):
    """The simulator's scenarios quantize buckets of 512, a size without a
    register shape: quantize and bucket_stats stage them in shared memory,
    and dequantize decodes them exactly."""
    vb, u = _values(dev, 900, 512, dt, seed=5)
    for levels, norm in ((lv.uniform_levels(3, device=dev), "l2"),
                         (lv.uniform_levels(8, device=dev), "linf")):
        assert _check_layout(vb, u, levels, norm) == "smem"
        codes, norms = ops.quantize_op(vb, u, levels, norm_type=norm)
        assert torch.equal(ops.dequantize_op(codes, norms, levels),
                           ref.dequantize_ref(codes, norms, levels))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [4, 8])
def test_ring_on_card_matches_cpu(dev, M):
    """The ring topology's per-hop re-quantization on the card against the
    CPU with the same uniforms: each (view, bucket) within 1e-6 of its
    largest value, except buckets where a rounding tie at one hop carried
    into the later hops (at most 1%), and the same bytes."""
    from repro_torch.sim import topology
    d, bs = 60_000, 512
    scheme = QuantScheme(bits=3, bucket_size=bs)
    plan = codec_for_scheme(scheme).plan(d, shards=M)
    g = torch.Generator().manual_seed(M)
    grads = torch.randn(M, d, generator=g) * 1e-2
    u_hops = [torch.rand(M, plan.shard_nb, bs, generator=g)
              for _ in range(2 * (M - 1))]
    cpu = topology.run_topology("ring", grads, scheme,
                                scheme.init_state("cpu"), u_hops=u_hops)
    before = kcuda.LAUNCHES["quantize"]
    card = topology.run_topology("ring", grads.to(dev), scheme,
                                 scheme.init_state(dev),
                                 u_hops=[x.to(dev) for x in u_hops])
    assert kcuda.LAUNCHES["quantize"] == before + 2 * (M - 1)  # one a hop
    n = plan.n
    pad = (0, n - d)
    a = torch.nn.functional.pad(card.aggregate.cpu(), pad).view(M, -1, bs)
    b = torch.nn.functional.pad(cpu.aggregate, pad).view(M, -1, bs)
    scale = b.abs().amax(dim=2, keepdim=True)
    ok = ((a - b).abs() <= 1e-6 * scale + 1e-30).all(dim=2)
    assert float(ok.float().mean()) >= 0.99
    assert (card.sent_bytes == cpu.sent_bytes).all()
    assert card.hops == cpu.hops == 2 * (M - 1)
    torch.testing.assert_close(card.quant_error.cpu(), cpu.quant_error,
                               rtol=1e-5, atol=0)


_GRAD_TWICE = """
import dataclasses, sys
import torch
from repro_torch import configs
from repro_torch.models.transformer import Model
if sys.argv[1] == "strict":
    torch.use_deterministic_algorithms(True)
cfg = dataclasses.replace(configs.get_config("llama3.2-1b"), num_layers=1)
model = Model(cfg, device="cuda", seed=0)
g = torch.Generator(device="cuda").manual_seed(0)
ids = torch.randint(0, cfg.vocab_size, (2, 1025), generator=g, device="cuda")
grads = []
for _ in range(2):
    grads.append(torch.zeros(model.d, device="cuda"))
    model.attach_grads(grads[-1])
    model.loss(ids[:, :-1], ids[:, 1:]).backward()
assert torch.equal(*grads), float((grads[0] - grads[1]).abs().max())
print("bit-equal")
"""


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["strict", "as_run"])
def test_two_backward_passes_give_bit_equal_gradients(dev, mode):
    """llama3.2-1b at full width, one layer, 2 x 1024 tokens: the same
    weights and tokens give the same gradient bits twice, in a process of
    its own; "strict" runs under ``torch.use_deterministic_algorithms``
    (which refuses an op on the path that has no deterministic version),
    "as_run" as the entry points run."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
               PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run([sys.executable, "-c", _GRAD_TWICE, mode], env=env,
                         capture_output=True, text=True)
    assert out.returncode == 0 and "bit-equal" in out.stdout, out.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("bits,norm", [(3, "l2"), (8, "linf")])
def test_core_encode_decode_on_card_match_plain_versions(dev, bits, norm):
    """``repro_torch.core``'s encode and decode launch the kernels on a
    card tensor and match the plain versions on the same tensors."""
    from repro_torch import core
    d, bs = 100_003, 1024
    g = torch.Generator(device=dev).manual_seed(bits)
    v = torch.randn(d, generator=g, device=dev) * 1e-2
    u = torch.rand(-(-d // bs), bs, generator=g, device=dev)
    levels = lv.uniform_levels(bits, device=dev)
    before = dict(kcuda.LAUNCHES)
    qt = core.encode(v, levels, u, bucket_size=bs, norm_type=norm)
    out = core.decode(qt, levels)
    assert kcuda.LAUNCHES["quantize"] == before.get("quantize", 0) + 1
    assert kcuda.LAUNCHES["dequantize"] == before.get("dequantize", 0) + 1
    vb = core.pad_to_buckets(v, bs)
    c2, n2 = ref.quantize_ref(vb, u, levels, norm)
    assert qt.dim == d and qt.codes.dtype == c2.dtype
    torch.testing.assert_close(qt.norms, n2, rtol=1e-5, atol=0)
    ref.code_mismatches(qt.codes, c2, vb, u, n2, levels)
    assert torch.equal(out, ref.dequantize_ref(qt.codes, qt.norms,
                                               levels).reshape(-1)[:d])


def _smoke_loss_and_grad(model, ids):
    grad = torch.zeros_like(model.flat)
    model.attach_grads(grad)
    loss = model.loss(ids[:, :-1], ids[:, 1:])
    loss.backward()
    return loss.item(), grad


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "llama4-scout-17b-a16e",
                                  "rwkv6-7b"])
def test_moe_and_rwkv_models_on_card_match_cpu(dev, arch):
    """The MoE (top-2; top-1 with the shared expert) and RWKV6 SMOKE
    configs, float32, 2 x 256 tokens: the loss (with the aux loss) on the
    card within 1e-6 of the CPU's, the flat gradient within 1e-5 of its
    largest entry, and two backward passes on the card bit-equal."""
    from repro_torch import configs
    from repro_torch.models.transformer import Model
    cfg = configs.get_smoke_config(arch)
    on_cpu = Model(cfg, device="cpu", seed=0)
    on_card = Model(cfg, device=dev, seed=0)
    on_card.load_flat(on_cpu.flat.to(dev))
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (2, 257), generator=g)
    lc, gc = _smoke_loss_and_grad(on_cpu, ids)
    lg, gg = _smoke_loss_and_grad(on_card, ids.to(dev))
    lg2, gg2 = _smoke_loss_and_grad(on_card, ids.to(dev))
    assert abs(lg - lc) <= 1e-6 * abs(lc), (lg, lc)
    err = float((gg.cpu() - gc).abs().max() / gc.abs().max())
    assert err <= 1e-5, err
    assert lg2 == lg and torch.equal(gg, gg2)


_GRAD_TWICE_SMOKE = """
import sys
import torch
from repro_torch import configs
from repro_torch.models.transformer import Model
torch.use_deterministic_algorithms(True)
cfg = configs.get_smoke_config(sys.argv[1])
model = Model(cfg, device="cuda", seed=0)
g = torch.Generator(device="cuda").manual_seed(0)
with torch.no_grad():
    # RWKV6's time-mix as a trained model has it (test_torch_model.py)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf.startswith("mu_"):
            p.uniform_(0.0, 1.0, generator=g)
        elif leaf == "w0":
            p.uniform_(-4.0, -0.5, generator=g)
        elif leaf == "w_lora_b":
            p.mul_(0.2)
        # Mamba's conv and the cross gate, zero at init (test_torch_model.py)
        elif leaf in ("conv_w", "conv_b"):
            p.normal_(generator=g).mul_(0.5)
        elif leaf == "gate":
            p.uniform_(0.5, 1.0, generator=g)
ids = torch.randint(0, cfg.vocab_size, (2, 1025), generator=g, device="cuda")
vision = (torch.randn(2, cfg.num_image_tokens, cfg.d_model, generator=g,
                      device="cuda") if cfg.cross_attn_every else None)
grads = []
for _ in range(2):
    grads.append(torch.zeros(model.d, device="cuda"))
    model.attach_grads(grads[-1])
    model.loss(ids[:, :-1], ids[:, 1:], vision).backward()
assert torch.isfinite(grads[0]).all(), int((~torch.isfinite(grads[0])).sum())
assert torch.equal(*grads), float((grads[0] - grads[1]).abs().max())
print("bit-equal and finite")
"""


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "rwkv6-7b"])
def test_moe_and_rwkv_backward_is_deterministic_on_card(dev, arch):
    """Under ``torch.use_deterministic_algorithms``, in a process of its
    own: no op of the MoE dispatch and combine or of the RWKV6 chunk loop
    is refused, and two backward passes of 2 x 1024 tokens give the same
    finite gradient.  RWKV6's token-shift mixes, w0 and LoRA are drawn as
    a trained model has them: at the init's log decays some channel of
    2 x 1024 random tokens overflows the reference's masked ``exp(diff)``
    and the gradient holds NaN in both packages (ROADMAP section 3)."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
               PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run([sys.executable, "-c", _GRAD_TWICE_SMOKE, arch],
                         env=env, capture_output=True, text=True)
    assert out.returncode == 0 and "bit-equal" in out.stdout, out.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b",
                                  "llama-3.2-vision-11b"])
def test_hybrid_and_vlm_models_on_card_match_cpu(dev, arch):
    """The jamba (Mamba, attention every 8th layer, MoE every 2nd) and
    llama-vision (cross-attention on the 5th layer, 16 image embeddings)
    SMOKE configs, float32, 2 x 256 tokens, with Mamba's conv weights and
    the cross gate drawn non-zero (zero at init, which would hide both
    blocks): the loss on the card within 1e-6 of the CPU's, the flat
    gradient within 1e-5 of its largest entry (5e-5 for jamba, whose 8
    layers' float32 gradient is itself ~2e-5 of its largest entry off a
    float64 evaluation on either device, while a bfloat16 computation
    reads far above the band: ``chip_smoke.py``'s hybrid/vlm check
    prints all three), and two backward passes on the card bit-equal;
    then the same two passes under
    ``torch.use_deterministic_algorithms`` at 2 x 1024 tokens, in a
    process of its own, bit-equal and finite."""
    import os
    import subprocess
    import sys
    from repro_torch import configs
    from repro_torch.models.transformer import Model
    cfg = configs.get_smoke_config(arch)
    on_cpu = Model(cfg, device="cpu", seed=0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in on_cpu.named_parameters():
            if name.endswith(("conv_w", "conv_b")):
                p.normal_(generator=g).mul_(0.5)
            elif name.endswith("gate"):
                p.uniform_(0.5, 1.0, generator=g)
    on_card = Model(cfg, device=dev, seed=0)
    on_card.load_flat(on_cpu.flat.to(dev))
    ids = torch.randint(0, cfg.vocab_size, (2, 257), generator=g)
    vision = (torch.randn(2, cfg.num_image_tokens, cfg.d_model, generator=g)
              if cfg.cross_attn_every else None)

    def loss_and_grad(model, dev):
        grad = torch.zeros_like(model.flat)
        model.attach_grads(grad)
        x = ids.to(dev)
        loss = model.loss(x[:, :-1], x[:, 1:],
                          None if vision is None else vision.to(dev))
        loss.backward()
        return loss.item(), grad

    lc, gc = loss_and_grad(on_cpu, "cpu")
    lg, gg = loss_and_grad(on_card, dev)
    lg2, gg2 = loss_and_grad(on_card, dev)
    assert abs(lg - lc) <= 1e-6 * abs(lc), (lg, lc)
    err = float((gg.cpu() - gc).abs().max() / gc.abs().max())
    assert err <= (5e-5 if cfg.layer_pattern == "mamba_hybrid" else 1e-5), err
    assert lg2 == lg and torch.equal(gg, gg2)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
               PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run([sys.executable, "-c", _GRAD_TWICE_SMOKE, arch],
                         env=env, capture_output=True, text=True)
    assert out.returncode == 0 and "bit-equal" in out.stdout, out.stderr


@pytest.mark.cuda
def test_bf16_train_step_on_card_matches_cpu(dev):
    """jamba-smoke with ``param_dtype="bfloat16"``, 2 workers x 2 x 64
    tokens, ALQ 3-bit with a level update, AdamW: one step on the card
    and on the CPU from the same weights and uniforms.  Parameters and
    gradient rows stay bfloat16 and the moments are float32 on the card;
    the three kernels launch; the loss within 1e-6 of the CPU's; the new
    parameters within one bfloat16 ulp of the CPU's at 99.5% of the
    coordinates (a rounding tie that went the other way moves a parameter
    by a whole AdamW step)."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models.transformer import Model
    from repro_torch.train.data import DataConfig, Pipeline
    from repro_torch.train.optim import OptimConfig
    from repro_torch.train.train_step import TrainConfig, Trainer
    cfg = dataclasses.replace(configs.get_smoke_config(
        "jamba-1.5-large-398b"), param_dtype="bfloat16")
    scheme = QuantScheme(name="alq", bits=3, bucket_size=1024)
    batch = Pipeline(DataConfig(kind="markov", vocab_size=cfg.vocab_size,
                                seq_len=64, global_batch=4)).batch(0, "cpu")
    on_cpu = Model(cfg, device="cpu", seed=0)
    plan = codec_for_scheme(scheme).plan(on_cpu.d)
    g = torch.Generator().manual_seed(2)
    u = [torch.rand(plan.nb, plan.bucket_size, generator=g) for _ in range(2)]
    out = []
    for d in ("cpu", dev):
        model = Model(cfg, device=d, seed=0)
        model.load_flat(on_cpu.flat.to(d))
        trainer = Trainer(model, TrainConfig(
            scheme=scheme, optim=OptimConfig(name="adamw", lr=1e-2),
            update_milestones=(0,), update_every=0, workers=2))
        before = dict(kcuda.LAUNCHES)
        m = trainer.train_step({k: v.to(d) for k, v in batch.items()},
                               u=[x.to(d) for x in u])
        out.append((m, trainer))
    (mc, tc), (mg, tg) = out
    assert all(kcuda.LAUNCHES.get(k, 0) > before.get(k, 0)
               for k in kcuda.KERNELS)
    assert tg.model.flat.dtype == tg.grads.dtype == torch.bfloat16
    assert tg.opt.mu.dtype == tg.opt.nu.dtype == torch.float32
    assert abs(mg["loss"] - mc["loss"]) <= 1e-6 * abs(mc["loss"])
    got, want = tg.model.flat.float().cpu(), tc.model.flat.float()
    close = ((got - want).abs() <= want.abs() * 2.0 ** -7).float().mean()
    assert close >= 0.995, float(close)


def _chip_smoke():
    """The repo's ``chip_smoke.py`` as a module: its serving helpers
    (``trained_like``, ``_serve_steps``, ``_steps_off``, ``_full_logits``,
    ``init_decays_against_float64``) serve these tests too."""
    import importlib.util
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-7b",
                                  "jamba-1.5-large-398b"])
def test_serve_on_card_matches_cpu(dev, arch):
    """A SMOKE config's prefill of 2 x 64 tokens and 4 decode steps
    (float32; ``trained_like`` weights: RWKV6's decays as a trained model
    has them, Mamba's conv drawn non-zero): the logits and every cache
    leaf on the card within 1e-5 of their largest entry on the CPU (5e-5
    for jamba, as its gradient band), and a second run on the card
    bit-equal to the first."""
    from repro_torch import configs
    from repro_torch.models.transformer import Model
    smoke = _chip_smoke()
    cfg = configs.get_smoke_config(arch)
    on_cpu = Model(cfg, device="cpu", seed=0)
    g = torch.Generator().manual_seed(3)
    smoke.trained_like(on_cpu, g)
    on_card = Model(cfg, device=dev, seed=0)
    on_card.load_flat(on_cpu.flat.to(dev))
    ids = torch.randint(0, cfg.vocab_size, (2, 68), generator=g)
    want = smoke._serve_steps(on_cpu, ids, None, 64, 4, 68)
    got = smoke._serve_steps(on_card, ids.to(dev), None, 64, 4, 68)
    again = smoke._serve_steps(on_card, ids.to(dev), None, 64, 4, 68)
    band = 5e-5 if cfg.layer_pattern == "mamba_hybrid" else 1e-5
    assert max(smoke._steps_off(got, want)) <= band
    for (lg, cg), (la, ca) in zip(got, again):
        assert torch.equal(lg, la)
        assert all(torch.equal(a, b) for x, y in zip(cg, ca)
                   for a, b in zip(x, y))


@pytest.mark.cuda
def test_serve_at_init_decays_against_float64(dev):
    """rwkv6's SMOKE config at the init's decays (w0 and the LoRA as
    initialised, the token-shift mixes drawn): a prefill of 2 x 64 and 4
    decode steps in float32 on the card and on the CPU, each within 5e-5
    of a float64 evaluation of the same formulas (logits and every cache
    leaf, over their largest entry; they read 1.1e-5 and 1.75e-5 on an
    H100): float32's own rounding there exceeds 1e-5, and it is what
    parts the card from the CPU (2.8e-5 apart)."""
    from repro_torch import configs
    from repro_torch.models.transformer import Model
    smoke = _chip_smoke()
    _, cpu, card = smoke.init_decays_against_float64(configs, Model)
    assert max(cpu + card) <= 5e-5, (cpu, card)


@pytest.mark.cuda
def test_attention_decode_wraps_the_sliding_ring_on_card(dev):
    """llama3.2's SMOKE config with a window of 8: a prompt of 5, then
    decode steps to position 20, which overwrite the ring of 8 slots
    twice: each step's logits on the card within 1e-5 of the largest
    entry of its own full forward's last position."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models.transformer import Model
    smoke = _chip_smoke()
    cfg = dataclasses.replace(configs.get_smoke_config("llama3.2-1b"),
                              attn_kind="sliding", window=8)
    model = Model(cfg, device=dev, seed=0)
    g = torch.Generator(device=dev).manual_seed(4)
    ids = torch.randint(0, cfg.vocab_size, (2, 21), generator=g, device=dev)
    logits, caches = model.prefill(ids[:, :5], max_len=32)
    assert caches[0][0].shape[2] == 8
    for t in range(5, 21):
        pos = torch.full((2,), t, dtype=torch.int32, device=dev)
        logits, caches = model.decode(ids[:, t], pos, caches)
        want = smoke._full_logits(model, ids[:, :t + 1], None)
        err = float((logits - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), (t, err)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# three steps of qwen3-0.6b's SMOKE config, a level update at step 1
SMOKE_RUN = ["--arch", "qwen3-0.6b", "--smoke", "--batch", "4", "--seq",
             "256", "--data", "uniform", "--update-at", "1", "--steps", "3"]


def _ranks(tmp_path, nproc: int, argv: list[str]) -> list[dict]:
    """The launcher in ``nproc`` processes under torchrun: each rank's
    losses and final parameters' digest."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc),
         os.path.join(ROOT, "tests", "torch_dist_worker.py"), "launch",
         str(tmp_path), *argv], env=env, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    ranks = []
    for r in range(nproc):
        with open(tmp_path / f"launch_rank{r}.json") as f:
            ranks.append(json.load(f))
    return ranks


def _stacked(argv: list[str], workers: int) -> tuple[list[float], str]:
    res = train.run(train.parse_args(argv + ["--device", "cuda:0",
                                             "--workers", str(workers)]))
    return ([h["loss"] for h in res["history"]],
            train.params_digest(res["trainer"].model.flat))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["all_gather", "two_phase"])
def test_gloo_ranks_sharing_the_card_equal_the_stacked_workers(dev, tmp_path,
                                                               mode):
    argv = SMOKE_RUN + ["--sync", mode]
    ranks = _ranks(tmp_path, 2, argv + ["--device", "cuda:0", "--backend",
                                        "gloo"])
    loss, digest = _stacked(argv, 2)
    assert all(math.isfinite(x) for x in loss)
    for r in ranks:
        assert r["loss"] == loss and r["digest"] == digest


@pytest.mark.cuda
def test_nccl_at_world_size_one_equals_one_stacked_worker(dev, tmp_path):
    ranks = _ranks(tmp_path, 1, SMOKE_RUN + ["--backend", "nccl"])
    loss, digest = _stacked(SMOKE_RUN, 1)
    assert (ranks[0]["loss"], ranks[0]["digest"]) == (loss, digest)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mixtral-8x7b",
                                  "jamba-1.5-large-398b"])
def test_remat_gradients_bit_equal_on_card(dev, arch):
    """A SMOKE config's loss and flat gradient on the card under every
    ``remat`` equal ``"none"``'s bit for bit (the hybrid's 8-slot groups
    checkpoint each slot too)."""
    from repro_torch import configs
    from repro_torch.models.transformer import REMAT_MODES, Model
    cfg = configs.get_smoke_config(arch)
    g = torch.Generator(device=dev).manual_seed(5)
    ids = torch.randint(0, cfg.vocab_size, (2, 129), generator=g,
                        device=dev)
    out = {}
    for remat in REMAT_MODES:
        model = Model(cfg, device=dev, seed=1, remat=remat)
        grad = torch.zeros_like(model.flat)
        model.attach_grads(grad)
        loss = model.loss(ids[:, :-1], ids[:, 1:])
        loss.backward()
        out[remat] = (loss.detach(), grad)
    assert torch.isfinite(out["none"][1]).all()
    for remat in REMAT_MODES[:-1]:
        assert torch.equal(out[remat][0], out["none"][0]), remat
        assert torch.equal(out[remat][1], out["none"][1]), remat


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["uniform", "entropy", "mixed_width"])
def test_fsdp_reduce_scatter_on_card_matches_cpu(dev, kind):
    """``_quantized_reduce_scatter`` of 4 stacked workers (buckets of 1024,
    with error feedback) on the card against the CPU with the same keys:
    shard means and residuals within 1e-6 of the terms' magnitude, and
    the card's encodes launch the CUDA quantize, its decodes dequantize."""
    from repro_torch.dist import fsdp
    from repro_torch.dist.transport import StackedTransport
    M, bs = 4, 1024
    scheme = QuantScheme(name="alq", bits=3, bucket_size=bs)
    codec = make_codec(scheme, kind)
    _, nb = fsdp.chunk_plan(40 * bs, bs, M)
    g = torch.Generator().manual_seed(8)
    rows = torch.randn((M, nb * bs), generator=g) * 1e-2
    res = torch.randn((M, nb * bs), generator=g) * 1e-3
    k = fsdp._rounds_for(nb // M) if codec.chunkable else 1
    # the same uniforms on both sides (a generator's stream depends on
    # its device)
    u = [[torch.rand(codec.rounding_shape(nb // k), generator=g)
          for _ in range(k)] for _ in range(M)]

    def run(d):
        return fsdp._quantized_reduce_scatter(
            rows.to(d), scheme.init_levels(d), None,
            transport=StackedTransport(M), codec=codec, residual=res.to(d),
            u=[[x.to(d) for x in w] for w in u])

    before = dict(kcuda.LAUNCHES)
    on_card = run(dev)
    torch.cuda.synchronize()
    launched = {k: kcuda.LAUNCHES[k] - before.get(k, 0) for k in kcuda.KERNELS}
    # one encode a worker and round (mixed widths: one quantize a group)
    assert launched["quantize"] >= M * k
    assert launched["dequantize"] >= M * k
    on_cpu = run("cpu")
    scale = float(rows.abs().max() + res.abs().max())
    for a, b in zip(on_card, on_cpu):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-6 * scale)


@pytest.mark.cuda
def test_fsdp_trainer_launches_the_kernels_on_card(dev):
    """Two stacked workers of qwen3-0.6b's SMOKE config in FSDP, two steps
    with a level update at step 1, on the card against the CPU: losses
    within rtol 1e-5; every encode of the reduce-scatter launches the CUDA
    quantize (the plain version never runs on card tensors), the level
    update bucket_stats."""
    from repro_torch import configs
    from repro_torch.models.transformer import Model
    from repro_torch.train.data import DataConfig, Pipeline
    from repro_torch.train.optim import OptimConfig
    from repro_torch.train.train_step import TrainConfig, Trainer
    from repro_torch.dist.fsdp import SeedKey

    class HostKey(SeedKey):
        """Draws on the CPU and moves the uniforms, so that both devices
        round with the same ones."""

        def fold(self, i):
            return HostKey(super().fold(i).seed)

        def uniform(self, shape, device):
            return super().uniform(shape, "cpu").to(device)

    cfg = configs.get_smoke_config("qwen3-0.6b")
    scheme = QuantScheme(name="alq", bits=3, bucket_size=256)
    pipe = Pipeline(DataConfig(kind="uniform", vocab_size=cfg.vocab_size,
                               seq_len=32, global_batch=4))
    weights = Model(cfg, device="cpu", seed=0, param_mode="fsdp", dp=2,
                    fsdp_scheme=scheme).flat
    losses = {}
    for d in (dev, torch.device("cpu")):
        model = Model(cfg, device=d, seed=0, param_mode="fsdp", dp=2,
                      fsdp_scheme=scheme)
        model.load_flat(weights)
        trainer = Trainer(model, TrainConfig(
            scheme=scheme, optim=OptimConfig(name="adamw", lr=1e-3),
            update_milestones=(1,), update_every=0, workers=2), seed=0,
            key=HostKey(0))
        kcuda.reset_launches()
        losses[d.type] = [trainer.train_step(pipe.batch(t, d))["loss"]
                          for t in range(2)]
        if d.type == "cuda":
            launched = dict(kcuda.LAUNCHES)
            assert launched["quantize"] > 0 and launched["dequantize"] > 0
            assert launched["bucket_stats"] > 0
        else:
            assert sum(kcuda.LAUNCHES.values()) == 0
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5)


@pytest.mark.cuda
def test_meta_peak_of_a_smoke_train_step_matches_the_card(dev):
    """The dry run's live-bytes count (``launch.op_cost``) of a train
    step on the meta device against the card's ``max_memory_allocated``
    for the same step, within 10%: two stacked workers of qwen3-0.6b's
    SMOKE config, 8 x 1024 tokens, ALQ 3-bit, buckets of 1024, AdamW,
    the level update.  The card's peak counts from what it held before
    the trainer was built, after a first step has made cuBLAS's
    workspaces (held across steps, on no meta device)."""
    from repro_torch import configs
    from repro_torch.launch import op_cost
    from repro_torch.models.transformer import Model
    from repro_torch.train.optim import OptimConfig
    from repro_torch.train.train_step import TrainConfig, Trainer

    cfg = configs.get_smoke_config("qwen3-0.6b")

    def step(device):
        model = Model(cfg, device=device, seed=0)
        trainer = Trainer(model, TrainConfig(
            scheme=QuantScheme(name="alq", bits=3, bucket_size=1024),
            optim=OptimConfig(name="adamw", lr=1e-4),
            update_milestones=(0,), update_every=0, workers=2), seed=0)
        toks = torch.zeros((8, 1025), dtype=torch.int64, device=device)
        trainer.step_tensors({"ids": toks[:, :-1], "labels": toks[:, 1:]})

    step(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step(dev)
    torch.cuda.synchronize()
    card = torch.cuda.max_memory_allocated() - base
    with op_cost.CostMode() as mode:
        step("meta")
    meta = mode.cost.peak_bytes
    print(f"meta peak {meta} B, card peak {card} B, meta/card - 1 = "
          f"{meta / card - 1.0:+.4%}")
    assert abs(meta / card - 1.0) <= 0.10, (meta, card)


def _spawn_card(path, world, device, backend):
    import torch.multiprocessing as mp
    import torch_tp_worker
    mp.start_processes(torch_tp_worker.spawn_card,
                       args=(world, str(path), device, backend),
                       nprocs=world, join=True, start_method="spawn")
    return [torch.load(path / f"rank{r}.pt") for r in range(world)]


@pytest.mark.cuda
def test_psum_tp_of_one_nccl_rank_is_the_tp1_path(dev, tmp_path):
    from repro_torch import configs
    from repro_torch.models.transformer import Model
    (got,) = _spawn_card(tmp_path, 1, "cuda:0", "nccl")
    cfg = configs.get_smoke_config("qwen3-0.6b")
    model = Model(cfg, device=dev, seed=0)
    model.load_flat(Model(cfg, device="cpu", seed=0).flat.to(dev))
    row = torch.zeros_like(model.flat)
    model.attach_grads(row)
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (2, 64), generator=g)
    loss = model.loss(ids.to(dev), ids.roll(1, 1).to(dev))
    loss.backward()
    x = torch.randn(3, 5, generator=g)
    assert torch.equal(got["loss"], loss.detach().cpu())
    assert torch.equal(got["grad"], row.cpu())
    assert torch.equal(got["psum"], x) and torch.equal(got["dpsum"], 2 * x)
    assert torch.equal(got["raw"], x)


@pytest.mark.cuda
def test_tp_pair_sharing_the_card_matches_the_cpu(dev, tmp_path):
    (tmp_path / "card").mkdir()
    (tmp_path / "cpu").mkdir()
    card = _spawn_card(tmp_path / "card", 2, "cuda:0", "gloo")
    cpu = _spawn_card(tmp_path / "cpu", 2, "cpu", "gloo")
    for a, b in zip(card, cpu):
        np.testing.assert_allclose(a["loss"].item(), b["loss"].item(),
                                   rtol=1e-6)
        scale = b["grad"].abs().max()
        assert (a["grad"] - b["grad"]).abs().max() <= 1e-5 * scale
        assert torch.equal(a["psum"], b["psum"])
        assert torch.equal(a["dpsum"], b["dpsum"])
        assert torch.equal(a["raw"], b["raw"])
    assert torch.equal(card[0]["psum"], card[1]["psum"])

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

  python3 chip_smoke.py

Phases, each of which must pass:
  1. set-up: the card's name and power limit; the four CUDA kernels
     (quantize, dequantize and dequantize_mean, bucket_stats) are built
     with nvcc from the three sources in ``src/repro_torch/csrc`` (one
     nvcc each, all at once) into ``build/kernels``; each source's build
     line gives its registers, shared memory and spill bytes (``-Xptxas
     -v``);
  2. kernel checks: each kernel against its plain PyTorch version on the
     card, at buckets of 1024 and 8192, f32 and bf16 values, l2 and linf
     norms, 3-bit and 8-bit grids, and in every bucket layout (registers
     at 1024 and 8192, shared memory for odd sizes and unaligned
     pointers, read twice beyond shared memory); dequantize and
     dequantize_mean as bit patterns; then at the shapes phases B-G give
     them, where each kernel is timed in 3 rounds (median and spread)
     beside its plain version and its bound (phase B's: dequantize at the
     4 streams' int32 and at one stream's int8, its own round trip, and
     dequantize_mean over the 4 streams' int8, with how many coordinates
     the decode-then-``mean(0)`` route moves at M = 3; the simulator's:
     the param server's 8-bit L-inf downlink, a ring hop over 4 workers'
     chunks, buckets of 512 in shared memory; phase H's 91,752 and phase
     I's 129,163 buckets of 8192), and the top-k selection is timed at
     full width;
  3. sync checks on the card against the same calls on the CPU (the
     plain versions), with the same gradients and uniforms, 4 workers:
     all_gather, two_phase without and with integrity words,
     compressed_allreduce with ef (two_phase) and topk (all_gather), the
     entropy-coded wire (all_gather; two_phase with integrity words; ef
     over it) and the mixed-width wire (all_gather, two_phase); the
     entropy words of the card equal the CPU's in every bucket whose codes
     agree; a table check: the gaussian-prior table fed a gradient that
     overflows every bucket's capacity flags every bucket that holds
     data, and the decode still equals the uniform codec's;
  4. fault check: a FaultyTransport flipping a word in a thousand on the
     card, all_gather and two_phase: with integrity words the aggregate
     is finite and the corrupt share of buckets is printed beside the
     share expected to hold a flipped word; without them, what the bare
     wire gives;
  5. sim check: each topology of ``repro_torch.sim`` on the card against
     the CPU with the same uniforms (d = 300,000, buckets of 1024, 4
     workers, 8 on the ring): allreduce, param_server with an 8-bit and
     without a downlink grid (equal to the allreduce bit for bit on the
     card), the ring, an active mask and crash weights on each, the
     mixed-width and entropy wires through allreduce and param_server,
     and ``run_compressed`` with ef on each; byte counts and hops equal;
  5b. API check: ``repro_torch.core``'s encode, decode and quantize on
     the card launch the kernels and match the plain versions;
     dense-config check: each new SMOKE config (granite-3-2b, qwen3-0.6b,
     qwen1.5-32b, musicgen-large) and llama3.2's with a sliding window
     and with chunks, one forward and backward pass of 2 x 1024 tokens
     on the card against the CPU with the same weights, then 4 quantized
     steps of each new SMOKE config through ``--smoke``;
     moe/rwkv config check: the mixtral, llama4-scout and rwkv6 SMOKE
     configs the same way (losses within 1e-6, gradients within 1e-5 of
     their largest entry), then 4 steps of each through ``--smoke``;
     hybrid/vlm config check: the jamba and llama-vision SMOKE configs
     with trained-like weights (open conv and gate), the same way
     (gradients within 5e-5 and 1e-5 of their largest entry), each also
     against float64 and against a bfloat16 control that must read
     outside the band, then 4 steps of each through ``--smoke``; vision
     step check: one 4-worker train step of llama-vision-smoke with image
     embeddings, card against CPU;
     determinism checks: llama3.2-1b, mixtral-8x7b (8 experts of d_ff
     14336, top-2, capacity 640, bf16) and rwkv6-7b (trained-like
     decays), each at full width, one layer, 2 x 1024 tokens: two
     backward passes give finite, bit-equal gradients, as the entry
     points run them and in a subprocess under deterministic algorithms
     (``--grad-twice CASE``, an arch or ``mamba-slot``), with the time
     and added peak memory of a pass; mixtral's first pass also reports
     its finite aux loss, the dropped share and the expert loads;
  6. phase A: paper-proxy, markov data, 4 workers, ALQ 3-bit, buckets of
     1024, level updates at steps 2 and 10, 16 steps through the
     training entry point: the loss falls, the levels move after step 2
     and the wire costs about 4.1 bits a coordinate;
  7. phase B: llama3.2-1b at full width cut to 4 layers, 4 workers of 2
     sequences of 1024 tokens, ALQ 3-bit, buckets of 8192, AdamW, a level
     update at step 1, 5 steps, all_gather: finite loss, time per step and
     per stage, peak memory and the stage that holds it (every phase run
     through the launcher prints it), and every kernel launched;
  8. phase C: the same model and batch, ``--sync two_phase --compress ef
     --integrity``, 5 steps: finite loss, stage times, peak memory, the
     plan's bits a coordinate (reduce + broadcast), no corrupt bucket on
     the clean wire, and every kernel launched;
  9. phase D: the same model, ``--sync all_gather --compress topk``, 3
     steps: finite loss, kept fraction 1927/8192, stage times (the top-k
     selection among them), peak memory, every kernel launched but
     dequantize_mean (the sparse codec decodes, then averages);
 10. phase E: phase B with ``--codec entropy``, 3 steps: finite loss,
     measured bits a coordinate above 0 and at most the plan's capacity,
     stage times (the Huffman coding is booked to pack and unpack), peak
     memory, quantize, dequantize and dequantize_mean launched;
 11. phase F: phase B with ``--codec mixed_width --sync two_phase`` (the
     default widths (2, 4): 4- and 16-level grids), 3 steps: finite loss,
     reduce and broadcast bits as planned, 8 group quantizes and 4
     phase-2 quantizes a step, stage times, peak memory;
 12. phase G: the cluster simulator at phase B's width (llama3.2-1b, 4
     layers, uniform data, 4 workers x 2 sequences of 1024, ALQ 3-bit,
     buckets of 8192, a level update at step 1, plain; the attention is
     deterministic, so the three runs compute the same gradients), 3 steps
     each of allreduce, param_server (8-bit downlink) and the ring through
     ``run_scenario``: per step the host-clock time, the stage split
     (grad, stats, drift, topology, optimizer), the bytes, the simulated
     time, agg_err and quant_error; per cell the peak memory and the
     launches (the ring's hops requantize: no dequantize_mean); finite
     losses, and at step 0 the param server's uplinks
     equal to the allreduce's encodes and its and the ring's agg_err
     above the allreduce's;
 12b. phase H: qwen3-0.6b at full width and full depth (28 layers, d =
     751,632,384; qk-norm, head_dim 128), 4 workers x 2 sequences of 1024
     uniform tokens, ALQ 3-bit, buckets of 8192, AdamW, a level update at
     step 1, 3 steps, all_gather: finite losses, the stage split, peak
     memory, every kernel launched, quantize and bucket_stats in the
     register layout;
 12c. phase I: rwkv6-7b at full width (d_model 4096, 64 heads of 64,
     d_ff 14336, vocab 65536) cut to 2 of its 32 layers (d =
     1,058,099,200), phase H's batch, scheme, buckets, optimizer and
     update step, 3 steps: finite losses, the stage split, peak memory,
     every kernel launched, quantize and bucket_stats in the register
     layout;
 13. scenario check: ``python -m repro_torch.sim`` (its ``main``) runs
     paper_mlp for 4 steps twice on the card (identical JSON, buckets of
     512 in shared memory) and once with ``--device cpu`` (equal bytes,
     hops, simulated times and fixed bits/coord), and fault_tolerance for
     4 steps on both (equal crash/rejoin events; corrupt buckets and a
     finite loss in the faulty cell);
 14. resume: paper-proxy, 4 workers, two_phase + ef through the launcher:
     8 steps straight, then 4 steps with ``--ckpt-dir`` and a second
     launch to 8 that resumes; the resumed losses and final parameters
     equal the straight run's;
 15. micro-batches: paper-proxy, 4 workers, ``--micro 2`` against
     ``--micro 1``, 4 steps: the losses agree at rtol 1e-4;
 15b. phase J and the Mamba width check: the determinism check of
     llama-3.2-vision-11b at full width, one group of 5 layers (d =
     2,183,184,385), 2 x 1024 tokens and 2 x 1601 image embeddings, and
     of jamba-1.5-large's slot 0 alone (``mamba-slot``: the Mamba mixer
     and the dense FFN, 1,024,327,680 bf16 parameters) on 2 x 1024
     hidden states, each with a ``torch.profiler`` split;
 15c. serving (none of the four kernels launches): the serve check,
     each of the 11 SMOKE configs with trained-like weights (the VLM with
     image embeddings), a prefill of 2 x 128 and 8 teacher-forced decode
     steps on the card against the CPU (logits and caches), twice
     bit-equal on the card, and 64 decode steps against the card's own
     full forward (MoE capacity raised so that nothing drops); rwkv6's
     SMOKE config at the init's decays, card and CPU each against a
     float64 evaluation; then ``python -m repro_torch.launch.serve``
     once; phase K, llama3.2-1b
     whole (16 layers, d = 1,498,482,688, bf16 compute) through
     ``make_prefill_step``/``make_decode_step``: 8 x 1024 prompt, 64
     greedy tokens, prefill ms, decode ms a step (median, spread),
     tokens/s, peak memory, the caches' bytes and a ``torch.profiler``
     split of one decode step, then at float32 compute prefill + 4 steps
     against the full forward (within 1e-4 of the largest logit and the
     reference's 4e-3; a control with the caches held in bfloat16 must
     read outside 1e-4); phase L, rwkv6-7b whole (32 layers, d =
     8,876,462,080), 4 x 512 prompt, 32 tokens, the same numbers, and at
     float32 a prompt of 480 + 32 steps against the full forward at 512
     (RWKV6's chunks of 32; band 3e-4, the same control);
 15d. phase M, data parallelism across processes, each run a subprocess
     of this script (``--rank-run``) while this process holds no large
     tensor on the card: M1, qwen3-0.6b at full width, 14 of its 28
     layers (d = 531,399,168), phase H's setting at M = 2 (2 x 1024
     uniform tokens a rank, ALQ 3-bit, buckets of 8192, AdamW, a level
     update at step 1, 3 steps, all_gather) in 2 gloo ranks sharing
     cuda:0 under ``python -m torch.distributed.run``, against the
     stacked launcher's ``--workers 2`` run of the same arguments; M2,
     its first 4 layers with ``--sync two_phase --compress ef
     --integrity``, 5 steps, in the same 2 ranks after M1; M3, NCCL at
     world size 1 with qwen3-0.6b's SMOKE config against ``--workers 1``;
     the three stacked runs share one process (``--rank-run ... --then``).
     Every rank's losses and final parameters' sha256 must equal the
     stacked run's (if not, both run again under deterministic
     algorithms, which must agree, and that is reported); per run the
     steady step time (median, spread), the stage split with its
     ``collective`` stage, each rank's peak memory and launches, and every
     rank launched all four kernels;
 15e. phase N, rematerialization and the chunked loss at full width:
     llama3.2-1b whole (16 layers, d = 1,498,482,688, V = 128,256), one
     worker's forward and backward of 1 x 4096 tokens under ``remat``
     "none" (twice), "dots" and "full" with the chunked loss and "full"
     with the whole-sequence loss, then 2 x 4096 (train_4k's rows a
     worker; "none" does not fit there) under "full" with either loss:
     ms and peak memory of each; "dots" and "full" bit-equal to "none"
     where two "none" passes are (else within their spread), the
     whole-sequence loss's gradient within 2^-6 of the largest entry (a
     few bfloat16 ulps: the chunks' LM-head gradients add in bfloat16);
 15f. phase O, FSDP, each run a subprocess (``--fsdp-run``): qwen3-0.6b
     whole, 2 workers x 2 x 1024 uniform tokens, ALQ 3-bit, buckets of
     8192, AdamW, a level update at step 1, 3 steps, through
     ``Model(param_mode="fsdp")`` and ``Trainer``: 2 gloo ranks sharing
     cuda:0 against the stacked M = 2 FSDP run (losses and every shard's
     sha256 bit-equal; every rank launches the three kernels FSDP
     runs: the reduce-scatter's quantize and dequantize, the level
     update's bucket_stats), then the float32 FSDP run against the DP run
     (losses rtol 1e-5, the first step's first moment within 1e-6 of its
     largest entry); per run the steps, stages, peak memory and launches;
     before them the FSDP rounds' kernel shapes ((240, 8192) a layer
     slot's round, (2376, 8192) embed's and lm_head's) against the plain
     versions, timed;
 15g. phase P, tensor parallelism, each run a subprocess: P1,
     qwen3-0.6b whole through the launcher's ``--tp 2`` on 4 gloo ranks
     sharing cuda:0 (2 data x 2 model; d = 405,209,088 a rank), phase H's
     setting at 2 data workers, 3 steps (``--rank-run``, each step's
     parameters fingerprinted on the card): the model ranks of each data
     rank report bit-equal losses, each model rank's two data ranks hold
     bit-equal parameters after every step, the losses are finite and
     every rank launches all four kernels; per rank the steps, stages,
     the model group's all-reduces (calls, bytes, ms), peak memory and
     launches; the kernels at P1's shapes against their plain versions
     before it; P1f (``--tp-check f32``), qwen3-0.6b whole at float32
     compute, one forward and backward at tp = 2 on 2 ranks against tp =
     1 with the same weights: the loss within rtol 1e-5, every sharded
     leaf's gradient and every replicated leaf's rank sum at 2x the tp =
     1 gradient within 1e-4 of the leaf's largest entry (the reference's
     transpose of psum, ROADMAP §3); P2 (``--tp-check p2``): one train
     step at tp = 2 of the mixtral, llama4-scout, rwkv6, jamba,
     llama-vision (with image embeddings) and granite SMOKE configs on 2
     ranks, card against CPU within the earlier card bands, every kernel
     launched;
 15h. phase Q, serving at tp > 1 (none of the four kernels launches):
     Q1 rides P1f/P2's pair of ranks (``--tp-check ... serve``,
     ``serve_tp``): llama3.2-1b whole at tp = 2 through
     ``make_prefill_step``/``make_decode_step`` with 2 cache shards, phase
     K's setting (8 x 1024 prompt, 64 greedy tokens, bf16 compute):
     prefill ms, decode ms a step (median, spread), tokens/s, a rank's
     peak memory and caches (half of phase K's), the model group's
     collectives of a decode step (all-reduces and all-gathers: calls,
     bytes, ms); at float32 compute the tp = 2 prefill and 4
     teacher-forced steps against tp = 1 on the same weights
     (``split_tp1``) within 1e-4 of the largest logit, the gathered
     caches too; then rwkv6's, jamba's, mixtral's, llama-vision's (with
     image embeddings) and qwen1.5's (5 heads padded to 6) SMOKE configs
     at tp = 2, card against CPU within the serve check's bands.  Q2
     rides P1's 4 gloo ranks (2 data x 2 model; ``--rank-run ... --then
     --serve-grid``, ``serve_grid``): the
     serve launcher's ``run`` at ``--tp 2`` on llama3.2's SMOKE config,
     each data rank's rows equal to its model group's serve of the whole
     batch; then the long-context layout, llama3.2-1b at full width cut
     to 4 layers, float32, batch 1, ``seq_shard_axes=("data", "model")``
     with 4 cache shards, a 4096-token prompt and 8 decode steps against
     the full forward within 1e-4 of the largest logit, prefill and
     decode ms;
 15i. phase R, the dry run (no kernel launches; nothing on the card):
     R2, ``python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape
     all --mesh single`` as a child (rank 0 of the 16 x 16 layout on the
     meta device under a fake process group; every record ok), runs
     while R1 counts phase H's update step and phase K's prefill and one
     decode step on the meta device (``launch.op_cost``): each meta peak
     within 10% of the card's peak for that phase less what the card
     held before it, and H's counted FLOPs over its measured update step
     as TFLOP/s and as a share of the H100 SXM5's dense bf16 989.4
     TFLOP/s at 700 W;
 16. last, measurements only: the blockwise attention's forward and
     backward against one ``scaled_dot_product_attention`` call at
     phase B's and phase H's layer shapes (ms, added memory), and a
     ``torch.profiler`` trace of one worker's forward and backward in
     phase H's and phase I's models (device busy time and idle share,
     launches, the ops with the most device time).

Output: per-phase lines, then the kernels' JSON line (launches summed
over phases B-I, the vision step, slice 8's ``--smoke`` runs, phase
M's ranks, phase O's and phase P's), then as the last
line {"ok": true, "device": {...}}.  Exits non-zero, with no such last
line, when a phase fails or no CUDA device is present.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_OPS_PER_S = 67e12         # H100 SXM, float32 outside the tensor cores
BS_B, D_B, M_B = 8192, 768_624_640, 4   # phases B-G: bucket, d, workers
NB_B, NB_RING = 93_832, 93_856  # buckets of d: one stream; the ring's plan
K_D = 1927                    # phase D's top-k: the equal wire budget
D_H, NB_H = 751_632_384, 91_752  # phase H: qwen3-0.6b whole, buckets of d
# phase M1: qwen3-0.6b at full width and half its depth (it was whole
# until phase Q came and the script had to give back its time)
M1_LAYERS, D_M1 = 14, 531_399_168
NEW_ARCHS = ("granite-3-2b", "qwen3-0.6b", "qwen1.5-32b", "musicgen-large")
MOE_RWKV_ARCHS = ("mixtral-8x7b", "llama4-scout-17b-a16e", "rwkv6-7b")
JAMBA, VLM = "jamba-1.5-large-398b", "llama-3.2-vision-11b"
MAMBA_SLOT = "mamba-slot"     # grad_twice's case of jamba's slot 0 alone
D_I, NB_I = 1_058_099_200, 129_163  # phase I: rwkv6-7b, 2 layers
D_K, D_L = 1_498_482_688, 8_876_462_080  # phases K, L: whole models
# phase P: a model rank of qwen3-0.6b at tp = 2, and its buckets of 8192
D_P, NB_P = 405_209_088, 49_464
# phase P2's SMOKE configs, each one step at tp = 2, card against CPU, and
# the earlier card bands of each (loss rtol, gradient of its largest entry)
P2_BANDS = {"mixtral-8x7b": (1e-6, 1e-5), "llama4-scout-17b-a16e": (1e-6, 1e-5),
            "rwkv6-7b": (1e-6, 1e-5), "jamba-1.5-large-398b": (1e-6, 5e-5),
            "llama-3.2-vision-11b": (1e-6, 1e-5),
            "granite-3-2b": (1e-5, 1e-4)}
# phase R: the meta device's peaks against the card's, and R2's dry run
PEAK_BAND = 0.10
R2_ARGV = ["--arch", "llama3.2-1b", "--shape", "all", "--mesh", "single"]
# the bytes on the card when a phase's peak counter was reset
PEAK_BASE: dict[str, int] = {}
# a register-resident entry point; groups: threads, elements a thread
REG_ENTRY = re.compile(r"_regsI.*Li(\d+)ELi(\d+)EEEv")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def timed(fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` on the card (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def timed_rounds(fns: dict, reps: int, rounds: int = 3
                 ) -> dict[str, tuple[float, float]]:
    """Median and spread (max - min) of ``rounds`` timings of each of
    ``fns``, taken in turns."""
    ts = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            ts[k].append(timed(fn, reps))
    return {k: (sorted(v)[len(v) // 2], max(v) - min(v))
            for k, v in ts.items()}


def f32_bits(x: "torch.Tensor") -> "torch.Tensor":
    """A float32 tensor's bit patterns (equal only where the values and
    the signs of zero are)."""
    import torch
    return x.contiguous().view(torch.int32)


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_grid(ops, ref, lv):
    """Each kernel against its plain version over the small grid."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    worst = {"quantize": 0.0, "dequantize": 0.0, "dequantize_mean": 0.0,
             "bucket_stats": 0.0}
    mismatches = 0
    for bs in (1024, 8192):
        for dt in (torch.float32, torch.bfloat16):
            for norm in ("l2", "linf"):
                for bits in (3, 8):
                    levels = lv.uniform_levels(bits, device=dev)
                    vb = (torch.randn(64, bs, generator=g, device=dev)
                          * 1e-2).to(dt)
                    u = torch.rand(64, bs, generator=g, device=dev)
                    c1, n1 = ops.quantize_op(vb, u, levels, norm_type=norm)
                    c2, n2 = ref.quantize_ref(vb, u, levels, norm)
                    check(c1.dtype == c2.dtype, "code dtype")
                    rel = float(((n1 - n2).abs() / n2).max())
                    # 8192-term float32 sums in another order
                    check(rel <= 1e-5, f"quantize norms rel err {rel}")
                    mismatches += ref.code_mismatches(c1, c2, vb, u, n2, levels)
                    worst["quantize"] = max(worst["quantize"],
                                            float((n1 - n2).abs().max()))
                    # x3: codes outside the table, as a corrupt wire gives
                    for c in (c1, c1.to(torch.int32), c1.to(torch.int32) * 3):
                        d1 = ops.dequantize_op(c, n1, levels)
                        d2 = ref.dequantize_ref(c, n1, levels)
                        check(torch.equal(f32_bits(d1), f32_bits(d2)),
                              "dequantize not bit-equal")
                        # two streams: these codes and their rows reversed
                        cm = torch.stack([c, c.flip(0)])
                        nm = torch.stack([n1, n1.flip(0)])
                        d1 = ops.dequantize_mean_op(cm, nm, levels)
                        d2 = ref.dequantize_mean_ref(cm, nm, levels)
                        check(torch.equal(f32_bits(d1), f32_bits(d2)),
                              "dequantize_mean not bit-equal")
                    for a, b in zip(ops.bucket_stats_op(vb, norm_type=norm),
                                    ref.bucket_stats_ref(vb, norm)):
                        check(torch.allclose(a, b, rtol=1e-5, atol=1e-7),
                              "bucket_stats beyond rtol 1e-5")
                        worst["bucket_stats"] = max(
                            worst["bucket_stats"], float((a - b).abs().max()))
    torch.cuda.synchronize()
    print(f"kernel grid: 16 cases per kernel agree with the plain versions; "
          f"{mismatches} codes differ by one at rounding ties; max abs "
          f"err {worst}", flush=True)
    return worst


def layout_grid(ref, lv, cuda, quantize_cuda, bucket_stats_cuda):
    """quantize and bucket_stats against their plain versions in the
    bucket layouts that the kernel grid does not reach: odd sizes and
    unaligned pointers (shared memory), buckets beyond shared memory
    (read twice in f32)."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    cases = [  # (name, nb, bs, element offset)
        ("unaligned 8192", 40, 8192, 1),
        ("4097", 40, 4097, 0),
        ("16384", 40, 16384, 0),
        ("65536", 8, 65536, 0),
    ]
    seen = set()
    for name, nb, bs, off in cases:
        for dt, norm, bits in ((torch.float32, "l2", 3),
                               (torch.bfloat16, "linf", 8)):
            levels = lv.uniform_levels(bits, device=dev)
            flat = torch.randn(nb * bs + off, generator=g, device=dev) * 1e-2
            vb = flat.to(dt)[off:].view(nb, bs)
            vb[0] = 0  # an all-zero bucket
            u = torch.rand(nb, bs, generator=g, device=dev)
            want = cuda.bucket_launch(
                bs, vb.element_size(), (vb.data_ptr(), u.data_ptr(), 0))
            seen.add(label(want))
            c1, n1 = quantize_cuda(vb, u, levels, norm)
            c2, n2 = ref.quantize_ref(vb, u, levels, norm)
            check(bool(torch.allclose(n1, n2, rtol=1e-5, atol=0)),
                  f"quantize norms, layout case {name}")
            ref.code_mismatches(c1, c2, vb, u, n2, levels)
            for a, b in zip(bucket_stats_cuda(vb, norm),
                            ref.bucket_stats_ref(vb, norm)):
                check(torch.allclose(a, b, rtol=1e-5, atol=1e-7),
                      f"bucket_stats, layout case {name}")
    torch.cuda.synchronize()
    check(seen == {"smem", "stream"}, f"layout grid reached {sorted(seen)}")
    print(f"layout grid: {len(cases) * 2} cases per kernel agree with the "
          f"plain versions, layouts {sorted(seen)}", flush=True)


def build_line(name: str, seconds, report: dict) -> str:
    """A kernel's build time and its ``-Xptxas -v`` report in one line:
    registers, static shared memory and spill bytes over its entry
    points, and per register-resident shape (threads x elements)."""
    regs = [v["registers"] for v in report.values()]
    smem = [v.get("smem", 0) for v in report.values()]
    spill = {k: v.get("spill_stores", 0) + v.get("spill_loads", 0)
             for k, v in report.items()}
    shapes: dict[str, list[str]] = {}
    for k in report:
        if m := REG_ENTRY.search(k):
            shapes.setdefault(f"{m[1]}x{m[2]}", []).append(k)
    per_shape = "".join(
        f"; register-resident {sh}: {len(ks)} entry points, registers "
        f"{min(report[k]['registers'] for k in ks)}-"
        f"{max(report[k]['registers'] for k in ks)}, spill bytes "
        f"{sum(spill[k] for k in ks)}" for sh, ks in sorted(shapes.items()))
    took = "built before" if seconds is None else f"{seconds:.1f} s"
    return (f"build {name}: {took}, {len(report)} entry points, registers "
            f"{min(regs)}-{max(regs)}, static smem <= {max(smem)} B, spill "
            f"bytes {sum(spill.values())}{per_shape}")


def label(launch) -> str:
    return (f"regs {launch.threads}x{launch.ept}" if launch.layout == "regs"
            else launch.layout)


def main_path_kernels(ops, ref, lv, cuda, codec_for_scheme, QuantScheme):
    """Each kernel at the shapes phase B gives it: agreement, kernel ms
    (median and spread of 3 rounds), plain ms (row chunks, to bound its
    temporaries) and the bound."""
    import torch
    dev = torch.device("cuda")
    plan = codec_for_scheme(QuantScheme(bits=3, bucket_size=BS_B)).plan(D_B)
    nb, n = plan.nb, plan.n
    g = torch.Generator(device=dev).manual_seed(1)
    levels = lv.uniform_levels(3, device=dev)
    L = levels.numel()
    chunks = 8
    rows = -(-nb // chunks)
    parts = range(0, nb, rows)
    pick = label(cuda.bucket_launch(BS_B, 4, (0,)))
    out = []

    vb = torch.randn(nb, BS_B, generator=g, device=dev) * 1e-3
    u = torch.rand(nb, BS_B, generator=g, device=dev)
    codes, norms = ops.quantize_op(vb, u, levels)
    worst, mism = 0.0, 0
    for i in parts:
        c2, n2 = ref.quantize_ref(vb[i:i + rows], u[i:i + rows], levels, "l2")
        check(bool(torch.allclose(norms[i:i + rows], n2, rtol=1e-5, atol=0)),
              "quantize norms at phase B's shape beyond rtol 1e-5")
        worst = max(worst, float((norms[i:i + rows] - n2).abs().max()))
        mism += ref.code_mismatches(codes[i:i + rows], c2, vb[i:i + rows],
                                    u[i:i + rows], n2, levels)
        del c2, n2
    del codes, norms
    t = timed_rounds({pick: lambda: ops.quantize_op(vb, u, levels)}, 5)
    plain = timed(lambda: [ref.quantize_ref(vb[i:i + rows], u[i:i + rows],
                                            levels, "l2") for i in parts], 1)
    # reads v (4 B) and u (4 B), writes a code (1 B); ~20 operations each
    b, by = bound_ms(n * 9 + nb * 4, n * (20 + math.log2(L)))
    out.append(dict(name="quantize", source="src/repro_torch/csrc/quantize.cu",
                    replaces="src/repro/kernels/quantize.py:34",
                    max_abs_err=worst, timings=t, pick=pick, plain_ms=plain,
                    bound_ms=b, bound_by=by, library_ms=None,
                    entry="quantize_regsIfaLi0ELi3ELi%dELi%dE"
                    % cuda.REG_SHAPES[BS_B],
                    note=f"({nb}, {BS_B}) f32, {mism} codes off by one at ties"))

    vals = ops.bucket_stats_op(vb)
    worst = 0.0
    for i in parts:
        for a, r in zip(vals, ref.bucket_stats_ref(vb[i:i + rows], "l2")):
            check(torch.allclose(a[i:i + rows], r, rtol=1e-5, atol=1e-7),
                  "bucket_stats at phase B's shape beyond rtol 1e-5")
            worst = max(worst, float((a[i:i + rows] - r).abs().max()))
    t = timed_rounds({pick: lambda: ops.bucket_stats_op(vb)}, 5)
    plain = timed(lambda: [ref.bucket_stats_ref(vb[i:i + rows], "l2")
                           for i in parts], 1)
    # reads v (4 B), writes 3 floats a bucket; ~8 operations an element
    b, by = bound_ms(n * 4 + nb * 12, n * 8)
    out.append(dict(name="bucket_stats",
                    source="src/repro_torch/csrc/bucket_stats.cu",
                    replaces="src/repro/kernels/bucket_stats.py:21",
                    max_abs_err=worst, timings=t, pick=pick, plain_ms=plain,
                    bound_ms=b, bound_by=by, library_ms=None,
                    entry="stats_regsIfLi0ELi%dELi%dE" % cuda.REG_SHAPES[BS_B],
                    note=f"({nb}, {BS_B}) f32"))
    del vb, u, vals

    # dequantize over the 4 streams' int32 codes in one call, as the
    # decode launched it before dequantize_mean (its earlier records' shape)
    g2 = torch.Generator(device=dev).manual_seed(2)
    c32 = torch.randint(-(L - 1), L, (M_B * nb, BS_B), generator=g2,
                        device=dev, dtype=torch.int32)
    n4 = torch.rand(M_B * nb, generator=g2, device=dev) + 0.1
    got = ops.dequantize_op(c32, n4, levels)
    rows4 = -(-M_B * nb // (chunks * M_B))
    for i in range(0, M_B * nb, rows4):
        check(torch.equal(f32_bits(got[i:i + rows4]),
                          f32_bits(ref.dequantize_ref(c32[i:i + rows4],
                                                  n4[i:i + rows4], levels))),
              "dequantize at phase B's shape not bit-equal")
    del got
    t = timed_rounds({"persistent grid":
                      lambda: ops.dequantize_op(c32, n4, levels)}, 3)
    plain = timed(lambda: [ref.dequantize_ref(c32[i:i + rows4],
                                              n4[i:i + rows4], levels)
                           for i in range(0, M_B * nb, rows4)], 1)
    # reads an int32 code, writes an f32 value; ~5 operations an element
    b, by = bound_ms(M_B * n * 8 + M_B * nb * 4, M_B * n * 5)
    out.append(dict(name="dequantize",
                    source="src/repro_torch/csrc/dequantize.cu",
                    replaces="src/repro/kernels/dequantize.py:18",
                    max_abs_err=0.0, timings=t, pick="persistent grid",
                    plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None,
                    entry="dequantize_vecIiE",
                    note=f"({M_B * nb}, {BS_B}) int32"))
    del c32, n4

    # the main path's decode: one dequantize_mean over the 4 streams' int8
    # codes (zero norms among them, so negative codes give -0 terms)
    c8, n8 = mean_inputs(M_B, nb, levels, g2)
    got = ops.dequantize_mean_op(c8, n8, levels)
    rows16 = -(-nb // 16)
    parts16 = range(0, nb, rows16)
    for i in parts16:
        check(torch.equal(f32_bits(got[i:i + rows16]), f32_bits(
            ref.dequantize_mean_ref(c8[:, i:i + rows16],
                                    n8[:, i:i + rows16], levels))),
              "dequantize_mean at phase B's shape not bit-equal")
    del got
    t = timed_rounds({"persistent grid":
                      lambda: ops.dequantize_mean_op(c8, n8, levels)}, 5)
    plain = timed(lambda: [ref.dequantize_mean_ref(
        c8[:, i:i + rows16], n8[:, i:i + rows16], levels)
        for i in parts16], 1)
    b, by = bound_ms(mean_bytes(M_B, nb, BS_B), M_B * n * 6)
    out.append(dict(name="dequantize_mean",
                    source="src/repro_torch/csrc/dequantize.cu",
                    replaces="none (src/repro/dist/sync.py:13-17: the "
                    "reference's decode then transport.mean_workers, fused)",
                    max_abs_err=0.0, timings=t, pick="persistent grid",
                    plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None,
                    entry="mean_vecIaLi0EE",
                    note=f"({M_B}, {nb}, {BS_B}) int8, the plain mean"))
    del c8, n8
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for k in out:
        timings = k.pop("timings")
        k["ms"], k["ms_spread"] = timings.pop(k["pick"])
        k["bound_share"] = k["bound_ms"] / k["ms"]
        entry = "; ".join(
            f"{v['registers']} registers, {v['spill_stores']} + "
            f"{v['spill_loads']} spill bytes"
            for e, v in cuda.ptxas_report(k["name"]).items()
            if k["entry"] in e)
        print(f"main-path shape {k['name']}: {k['note']}, {k['pick']}: "
              f"kernel {k['ms']:.3f} ms (spread {k['ms_spread']:.3f} over 3 "
              f"rounds), plain {k['plain_ms']:.3f} ms, bound "
              f"{k['bound_ms']:.3f} ms ({k['bound_by']}), "
              f"{k['bound_share']:.0%} of bound, max abs err "
              f"{k['max_abs_err']:.3g}, ptxas: {entry}",
              flush=True)
    return out


def record_shape(out, label, name, shape, fn, plain_fn, b_bytes, ops_n,
                 worst, note):
    """Time kernel ``name`` at ``shape`` in 3 rounds beside its plain
    version and its bound; append the record to ``out[name]``."""
    t = timed_rounds({"k": fn}, 5)["k"]
    plain = timed(plain_fn, 1)
    b, by = bound_ms(b_bytes, ops_n)
    out.setdefault(name, []).append(dict(
        shape=shape, ms=t[0], ms_spread=t[1], plain_ms=plain, bound_ms=b,
        bound_by=by, bound_share=b / t[0], max_abs_err=worst, note=note))
    print(f"{label} {name} {shape}: {note}: kernel {t[0]:.3f} ms "
          f"(spread {t[1]:.3f}), plain {plain:.3f} ms, bound {b:.3f} ms "
          f"({by}), {b / t[0]:.0%} of bound, max abs err {worst:.3g}",
          flush=True)


def chunks(rows, parts=8):
    """Row ranges for the plain versions, to bound their temporaries."""
    step = -(-rows // parts)
    return range(0, rows, step), step


def mean_inputs(M, nb, levels, g):
    """(M, nb, 8192) int8 codes over ``levels`` and (M, nb) norms, every
    7th bucket's norm 0."""
    import torch
    L = levels.numel()
    codes = torch.randint(-(L - 1), L, (M, nb, BS_B), generator=g,
                          device=levels.device, dtype=torch.int8)
    norms = torch.rand(M, nb, generator=g, device=levels.device) + 0.1
    norms[:, ::7] = 0.0
    return codes, norms


def mean_bytes(M, nb, bs) -> int:
    """The bytes dequantize_mean must move: M int8 codes and M norms a
    bucket read, one f32 value a coordinate written (its operations: ~6
    a term)."""
    n = nb * bs
    return M * n + M * nb * 4 + n * 4


def decode_shapes(ops, ref, lv, out, nb=NB_B):
    """The main path's dequantize, a stream's own int8 rows at phase B's
    nb, timed (record appended to ``out``); then the mean's order at M =
    3 and 4: how many coordinates today's fused mean (sum, then divide)
    and the decode-then-``mean(0)`` route it replaced (ATen's CUDA mean
    multiplies by 1/M) part on.  Returns those counts."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    levels = lv.uniform_levels(3, device=dev)
    c8, n8 = mean_inputs(1, nb, levels, g)
    c8, n8 = c8[0], n8[0]
    got = ops.dequantize_op(c8, n8, levels)
    parts, rows = chunks(nb, 16)
    for i in parts:
        want = ref.dequantize_ref(c8[i:i + rows], n8[i:i + rows], levels)
        check(torch.equal(f32_bits(got[i:i + rows]), f32_bits(want)),
              "dequantize of one int8 stream not bit-equal")
    del got
    n = nb * BS_B
    record_shape(out, "main-path shape", "dequantize",
                 f"({nb}, {BS_B}) int8",
                 lambda: ops.dequantize_op(c8, n8, levels),
                 lambda: [ref.dequantize_ref(c8[i:i + rows], n8[i:i + rows],
                                             levels) for i in parts],
                 n * 5 + nb * 4, n * 5, 0.0,
                 "a worker's own round trip from its row of the codes")
    del c8, n8
    moved = {}
    for M in (3, 4):
        codes, norms = mean_inputs(M, nb, levels, g)
        old = ops.dequantize_op(codes.view(M * nb, BS_B), norms.view(-1),
                                levels).view(M, -1).mean(0)
        new = ops.dequantize_mean_op(codes, norms, levels).view(-1)
        moved[M] = int((f32_bits(old) != f32_bits(new)).sum())
        rel = float(((old - new).abs() / new.abs().clamp(min=1e-30)).max())
        del old, new, codes, norms
        print(f"mean order at M = {M}, ({nb}, {BS_B}) int8: decode then "
              f"mean(0) against dequantize_mean (sum, then divide) differ "
              f"at {moved[M]} of {n} coordinates ({moved[M] / n:.4%}), "
              f"largest relative difference {rel:.3g}", flush=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return moved


def slice_shapes(ops, ref, lv, codec_for_scheme, QuantScheme, SparseCodec,
                 resample_levels):
    """Each kernel at the shapes phases C, D and F give it, against its
    plain version, timed in 3 rounds beside the plain version and the
    bound; and the top-k selection at full width.  Returns kernel name ->
    shape records."""
    import torch
    dev = torch.device("cuda")
    M = M_B
    plan = codec_for_scheme(QuantScheme(bits=3, bucket_size=BS_B)).plan(
        D_B, shards=M)
    snb, nb_d = plan.shard_nb, codec_for_scheme(
        QuantScheme(bits=3, bucket_size=BS_B)).plan(D_B).nb
    g = torch.Generator(device=dev).manual_seed(5)
    lv3 = lv.uniform_levels(3, device=dev)
    lv8 = lv.uniform_levels(8, device=dev)
    out: dict[str, list] = {"quantize": [], "dequantize": []}

    def record(*args):
        record_shape(out, "slice shape", *args)

    # phase 2: each rank's shard mean on the 8-bit L-inf grid, int16 codes
    vb = torch.randn(snb, BS_B, generator=g, device=dev) * 1e-3
    u = torch.rand(snb, BS_B, generator=g, device=dev)
    codes, norms = ops.quantize_op(vb, u, lv8, norm_type="linf")
    check(codes.dtype == torch.int16, "phase-2 codes are not int16")
    parts, rows = chunks(snb)
    mism = 0
    for i in parts:
        c2, n2 = ref.quantize_ref(vb[i:i + rows], u[i:i + rows], lv8, "linf")
        check(torch.equal(norms[i:i + rows], n2), "phase-2 L-inf norms")
        mism += ref.code_mismatches(codes[i:i + rows], c2, vb[i:i + rows],
                                    u[i:i + rows], n2, lv8)
    n = snb * BS_B
    record("quantize", f"({snb}, {BS_B}) f32 linf 8-bit",
           lambda: ops.quantize_op(vb, u, lv8, norm_type="linf"),
           lambda: [ref.quantize_ref(vb[i:i + rows], u[i:i + rows], lv8,
                                     "linf") for i in parts],
           n * 10 + snb * 4, n * (20 + 8), 0.0,
           f"phase 2, one rank, int16 codes, {mism} codes off by one at ties")
    del vb, u, codes, norms

    # the top-k selection at full width, then its kept rows of 1927 f32
    vb = torch.randn(nb_d, BS_B, generator=g, device=dev) * 1e-3
    sparse = SparseCodec(num_levels=8, bucket_size=BS_B, k=K_D)
    sel, idx = sparse.select(vb)
    want = torch.topk(vb[:64].abs(), K_D, dim=1).values.sort(dim=1).values
    check(torch.equal(sel[:64].abs().sort(dim=1).values, want),
          "top-k selection keeps other magnitudes than torch.topk")
    t_sel = timed_rounds({"k": lambda: sparse.select(vb)}, 1)["k"]
    t_lib = timed(lambda: torch.topk(vb.abs(), K_D, dim=1), 1)
    print(f"top-k selection ({nb_d}, {BS_B}) f32 -> k={K_D}: "
          f"{t_sel[0]:.3f} ms (spread {t_sel[1]:.3f}) a worker; one "
          f"torch.topk call (no tie order) {t_lib:.3f} ms", flush=True)
    del vb, idx
    u = torch.rand(nb_d, K_D, generator=g, device=dev)
    check(sel.stride(0) * 4 % 16 != 0, "top-k rows are 16-byte aligned")
    codes, norms = ops.quantize_op(sel, u, lv3)
    parts, rows = chunks(nb_d)
    worst, mism = 0.0, 0
    for i in parts:
        c2, n2 = ref.quantize_ref(sel[i:i + rows], u[i:i + rows], lv3, "l2")
        check(bool(torch.allclose(norms[i:i + rows], n2, rtol=1e-5, atol=0)),
              "top-k quantize norms beyond rtol 1e-5")
        worst = max(worst, float((norms[i:i + rows] - n2).abs().max()))
        mism += ref.code_mismatches(codes[i:i + rows], c2, sel[i:i + rows],
                                    u[i:i + rows], n2, lv3)
    n = nb_d * K_D
    record("quantize", f"({nb_d}, {K_D}) f32 l2 3-bit",
           lambda: ops.quantize_op(sel, u, lv3),
           lambda: [ref.quantize_ref(sel[i:i + rows], u[i:i + rows], lv3,
                                     "l2") for i in parts],
           n * 9 + nb_d * 4, n * 23, worst,
           f"top-k kept values, unaligned rows, {mism} codes off by one at "
           "ties")
    del sel, u, codes, norms

    g2 = torch.Generator(device=dev).manual_seed(6)
    for shape, L, levels, note in (
            ((M * snb, BS_B), 8, lv3, "phase-1 shard of one rank, int32"),
            ((M * nb_d, K_D), 8, lv3, "top-k streams of 4 workers, int32")):
        c32 = torch.randint(-(L - 1), L, shape, generator=g2, device=dev,
                            dtype=torch.int32)
        n4 = torch.rand(shape[0], generator=g2, device=dev) + 0.1
        got = ops.dequantize_op(c32, n4, levels)
        parts, rows = chunks(shape[0], 16)
        for i in parts:
            check(torch.equal(got[i:i + rows], ref.dequantize_ref(
                c32[i:i + rows], n4[i:i + rows], levels)),
                f"dequantize {shape} not exact")
        del got
        n = shape[0] * shape[1]
        record("dequantize", f"({shape[0]}, {shape[1]}) int32",
               lambda: ops.dequantize_op(c32, n4, levels),
               lambda: [ref.dequantize_ref(c32[i:i + rows], n4[i:i + rows],
                                           levels) for i in parts],
               n * 8 + shape[0] * 4, n * 5, 0.0, note)
        del c32, n4

    # phase F's width groups: the default (2, 4) cycle splits each worker's
    # buckets in halves, quantized over gathered rows on the 3-bit grid
    # resampled to 4 and 16 levels; each rank decodes a group of its shard
    # from 4 streams, the same count of rows
    half = plan.nb // 2
    for bits in (2, 4):
        lvg = resample_levels(lv3, 2 ** bits)
        L = lvg.numel()
        vb = torch.randn(half, BS_B, generator=g, device=dev) * 1e-3
        u = torch.rand(half, BS_B, generator=g, device=dev)
        codes, norms = ops.quantize_op(vb, u, lvg)
        parts, rows = chunks(half)
        worst, mism = 0.0, 0
        for i in parts:
            c2, n2 = ref.quantize_ref(vb[i:i + rows], u[i:i + rows], lvg, "l2")
            check(bool(torch.allclose(norms[i:i + rows], n2, rtol=1e-5,
                                      atol=0)),
                  f"mixed-width quantize norms ({L} levels) beyond rtol 1e-5")
            worst = max(worst, float((norms[i:i + rows] - n2).abs().max()))
            mism += ref.code_mismatches(codes[i:i + rows], c2, vb[i:i + rows],
                                        u[i:i + rows], n2, lvg)
        n = half * BS_B
        record("quantize", f"({half}, {BS_B}) f32 l2 {L} levels",
               lambda: ops.quantize_op(vb, u, lvg),
               lambda: [ref.quantize_ref(vb[i:i + rows], u[i:i + rows], lvg,
                                         "l2") for i in parts],
               n * 9 + half * 4, n * (20 + math.log2(L)), worst,
               f"phase F width group of one worker, {mism} codes off by one "
               "at ties")
        del vb, u, codes, norms
        c32 = torch.randint(-(L - 1), L, (half, BS_B), generator=g2,
                            device=dev, dtype=torch.int32)
        n4 = torch.rand(half, generator=g2, device=dev) + 0.1
        got = ops.dequantize_op(c32, n4, lvg)
        parts, rows = chunks(half, 16)
        for i in parts:
            check(torch.equal(got[i:i + rows], ref.dequantize_ref(
                c32[i:i + rows], n4[i:i + rows], lvg)),
                f"dequantize ({L} levels) not exact")
        del got
        record("dequantize", f"({half}, {BS_B}) int32 {L} levels",
               lambda: ops.dequantize_op(c32, n4, lvg),
               lambda: [ref.dequantize_ref(c32[i:i + rows], n4[i:i + rows],
                                           lvg) for i in parts],
               n * 8 + half * 4, n * 5, 0.0,
               "phase F width group of one rank's shard, 4 streams")
        del c32, n4
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out, t_sel


def _bucket_scale(x: "torch.Tensor", bs: int) -> "torch.Tensor":
    """Per coordinate, the largest bucket L2 norm over the workers' rows
    of ``x`` (M, d): a bound on every decoded term of that coordinate."""
    import torch
    M, d = x.shape
    pad = -d % bs
    xb = torch.nn.functional.pad(x, (0, pad)).view(M, -1, bs)
    s = torch.linalg.vector_norm(xb, dim=2).amax(0)
    return s.repeat_interleave(bs)[:d]


def _agree(name, gpu, cpu, scale):
    """Card against CPU: each coordinate within 1e-6 of its terms' scale
    (norms summed in another order differ in the last ulp), except where
    a rounding tie went the other way: at most 0.1% of them."""
    import torch
    gpu = gpu.cpu()
    check(gpu.shape == cpu.shape and bool(torch.isfinite(gpu).all()),
          f"{name}: output shape or finiteness")
    err = (gpu - cpu).abs()
    close = float((err <= 1e-6 * scale + 1e-12).float().mean())
    check(close >= 0.999, f"{name}: card agrees with CPU at only {close:.5f}")
    return close, float(err.max())


def sync_check(sync, compress, QuantScheme, make_codec):
    """4-worker all-reduces on the card (kernels) against the CPU (plain
    versions), with the same gradients and uniforms, in every wire mode
    and compression of this slice."""
    import torch
    M, d, bs = 4, 300_000, 1024
    scheme = QuantScheme(bits=3, bucket_size=bs)
    g = torch.Generator().manual_seed(3)
    grads = torch.randn(M, d, generator=g) * 1e-2
    residual = torch.randn(M, d, generator=g) * 3e-3

    def uniforms(plan, k):
        u = [torch.rand(plan.nb, k, generator=g) for _ in range(M)]
        u2 = [torch.rand(plan.shard_nb, bs, generator=g) for _ in range(M)]
        return u, u2

    for mode, kind, integrity in (
            ("all_gather", "uniform", False), ("two_phase", "uniform", False),
            ("two_phase", "uniform", True), ("all_gather", "entropy", False),
            ("two_phase", "entropy", True),
            ("all_gather", "mixed_width", False),
            ("two_phase", "mixed_width", False)):
        codec = make_codec(scheme, kind, integrity=integrity)
        plan = codec.plan(d, shards=M if mode == "two_phase" else 1)
        u, u2 = uniforms(plan, bs)
        cpu, m0 = sync.quantized_allreduce(
            grads.clone(), scheme, scheme.init_state("cpu"), mode=mode,
            codec=codec, u=u, u2=u2)
        gpu, m = sync.quantized_allreduce(
            grads.cuda(), scheme, scheme.init_state("cuda"), mode=mode,
            codec=codec, u=[x.cuda() for x in u], u2=[x.cuda() for x in u2])
        name = (f"{mode}{'' if kind == 'uniform' else ' ' + kind}"
                f"{' + integrity' if integrity else ''}")
        close, worst = _agree(name, gpu, cpu, _bucket_scale(grads, bs))
        check(m.comm_bits_per_coord == m0.comm_bits_per_coord,
              f"{name}: bits/coord {m.comm_bits_per_coord} on the card, "
              f"{m0.comm_bits_per_coord} on the CPU")
        check(not bool(m.corrupt_fraction.any()), f"{name}: corrupt buckets")
        print(f"sync check {name}: M={M} d={d} card vs CPU: {close:.6f} of "
              f"coords within 1e-6 of their terms, max abs diff {worst:.3g}, "
              f"{m.comm_bits_per_coord:.4f} bits/coord"
              f"{' (measured)' if plan.variable else ''}", flush=True)

    for spec, mode, kind in (("ef", "two_phase", "uniform"),
                             ("topk", "all_gather", "uniform"),
                             ("ef", "all_gather", "entropy")):
        algo = compress.make_algorithm(
            spec, scheme,
            codec=None if kind == "uniform" else make_codec(scheme, kind))
        plan = algo.codec.plan(d, shards=M if mode == "two_phase" else 1)
        u, u2 = uniforms(plan, getattr(algo.codec, "k", bs))
        states, outs = [], []
        for dev in ("cpu", "cuda"):
            st = algo.init_state(M, d, dev)
            st.residual.copy_(residual)
            to = (lambda xs: [x.to(dev) for x in xs])
            # a copy: the residual is added to the gradient rows in place
            out, st, m = sync.compressed_allreduce(
                grads.to(dev, copy=True), scheme, scheme.init_state(dev),
                algo, st,
                mode=mode, u=to(u), u2=to(u2))
            states.append(st)
            outs.append(out)
        scale = _bucket_scale(grads + residual, bs)
        name = f"{spec}{'' if kind == 'uniform' else ' over ' + kind}"
        close, worst = _agree(f"{name} ({mode})", outs[1], outs[0], scale)
        rclose, rworst = _agree(f"{name} residual",
                                states[1].residual[0],
                                states[0].residual[0], scale)
        check(m.kept_fraction == algo.kept_fraction, f"{name}: kept")
        print(f"sync check {name} ({mode}): card vs CPU: aggregate "
              f"{close:.6f} within 1e-6 (max abs diff {worst:.3g}), "
              f"worker 0's residual {rclose:.6f} (max {rworst:.3g}), "
              f"kept {m.kept_fraction:.4f}, {m.comm_bits_per_coord:.4f} "
              "bits/coord", flush=True)


def entropy_words_check(ops, QuantScheme, make_codec):
    """The entropy encoder's words on the card against the CPU's for the
    same values and uniforms: a sharded integrity plan of 4 segments.  A
    bucket's header and region words are equal wherever its codes agree on
    both devices (a code moved at a rounding tie changes the run), and its
    checksum word where its norm bits agree too."""
    import torch
    M, d, bs = 4, 300_000, 1024
    scheme = QuantScheme(bits=3, bucket_size=bs)
    codec = make_codec(scheme, "entropy", integrity=True)
    plan = codec.plan(d, shards=M)
    g = torch.Generator().manual_seed(9)
    flat = torch.randn(d, generator=g) * 1e-2
    u = torch.rand(plan.nb, bs, generator=g)
    lv = scheme.init_levels("cpu")
    out = []
    for dev in ("cpu", "cuda"):
        vb = codec.bucketize(flat.to(dev), plan)
        pay = codec.encode(vb, lv.to(dev), plan=plan, u=u.to(dev))
        codes, norms = ops.quantize_op(vb, u.to(dev), lv.to(dev))
        out.append((pay.words.cpu(), codes.cpu(), norms.cpu()))
    (w0, c0, n0), (w1, c1, n1) = out
    snb, cap = plan.shard_nb, codec.cap_words
    same = (c0 == c1).all(dim=1).view(M, snb)
    nsame = same & (n0 == n1).view(M, snb)
    head_ok = (w0[:, snb:2 * snb] == w1[:, snb:2 * snb])[same].all()
    region_ok = (w0[:, 2 * snb:].view(M, snb, cap)
                 == w1[:, 2 * snb:].view(M, snb, cap)).all(dim=2)[same].all()
    csum_ok = (w0[:, :snb] == w1[:, :snb])[nsame].all()
    check(bool(head_ok and region_ok and csum_ok),
          "entropy words differ between card and CPU where codes agree")
    check(int(same.sum()) >= 0.99 * M * snb,
          f"entropy words: codes agree in only {int(same.sum())} buckets")
    print(f"entropy words: card equals CPU in all {int(same.sum())} of "
          f"{M * snb} buckets whose codes agree (checksums in the "
          f"{int(nsame.sum())} whose norm bits agree too)", flush=True)


def table_check(QuantScheme, make_codec, from_int32_bits):
    """The gaussian-prior (cold-start) table of an L-inf scheme fed uniform
    magnitudes, which its short codes do not expect: every bucket that
    holds data overflows its capacity and falls back to fixed width, and
    the decode still equals the uniform codec's."""
    import torch
    d, bs = 300_000, 1024
    scheme = QuantScheme(name="qsgdinf", bits=3, bucket_size=bs)
    ec, uc = make_codec(scheme, "entropy"), make_codec(scheme)
    pe, pu = ec.plan(d), uc.plan(d)
    g = torch.Generator(device="cuda").manual_seed(10)
    flat = torch.rand(d, generator=g, device="cuda") * 2 - 1
    u = torch.rand(pe.nb, bs, generator=g, device="cuda")
    lv = scheme.init_levels("cuda")
    pay = ec.encode(ec.bucketize(flat, pe), lv, plan=pe, u=u)
    flags = from_int32_bits(pay.words[:pe.shard_nb]) >> 31
    held = -(-d // bs)
    check(bool(flags[:held].all()),
          f"table check: {int(flags[:held].sum())} of {held} buckets fell "
          "back")
    got = ec.decode(pay, lv, pe)
    want = uc.decode(uc.encode(uc.bucketize(flat, pu), lv, plan=pu, u=u), lv,
                     pu)
    check(torch.equal(got, want), "table check: fallback decode differs "
                                  "from the uniform codec's")
    mb = ec.measured_bits_per_coord(pay, pe)
    print(f"table check: all {held} buckets holding data fell back to fixed "
          f"width; decode equals the uniform codec's; {mb:.4f} bits/coord "
          f"measured (capacity {pe.bits_per_coord:.4f}, uniform plan "
          f"{pu.bits_per_coord:.4f})", flush=True)


def fault_check(sync, faults, transport, QuantScheme, make_codec,
                wire_bits_for):
    """A word in a thousand flipped on the wire, on the card."""
    import torch
    M, d, bs, p = 4, 300_000, 1024, 1e-3
    scheme = QuantScheme(bits=3, bucket_size=bs)
    dev = torch.device("cuda")
    grads = torch.randn(M, d, generator=torch.Generator().manual_seed(8),
                        ).to(dev) * 1e-2
    fm = faults.FaultModel(flip_prob=p, seed=1)
    clean = make_codec(scheme)
    # words a bucket rides on: its symbols, a checksum and a norm word
    k1 = bs * wire_bits_for(scheme.num_levels) // 32 + 2
    k2 = bs * wire_bits_for(256) // 32 + 2
    share1, share2 = 1 - (1 - p) ** k1, 1 - (1 - p) ** k2
    for mode, expect in (("all_gather", share1),
                         ("two_phase", (share1 + share2) / 2)):
        for integrity in (True, False):
            out, m = sync.quantized_allreduce(
                grads, scheme, scheme.init_state(dev), mode=mode,
                transport=faults.faulty(transport.StackedTransport(M), fm, 0),
                codec=make_codec(scheme, integrity=integrity),
                generator=torch.Generator(device=dev).manual_seed(0))
            ref, _ = sync.quantized_allreduce(
                grads, scheme, scheme.init_state(dev), mode=mode,
                codec=clean,
                generator=torch.Generator(device=dev).manual_seed(0))
            finite = bool(torch.isfinite(out).all())
            ok = torch.isfinite(out)
            err = float((out[ok] - ref[ok]).abs().max())
            if integrity:
                cf = float(m.corrupt_fraction.mean())
                check(finite, f"fault check {mode}: aggregate not finite")
                check(cf > 0, f"fault check {mode}: no corrupt bucket seen")
                print(f"fault check {mode} + integrity, flip_prob {p}: "
                      f"finite, corrupt share {cf:.4f} (expected "
                      f"{expect:.4f}: buckets holding a flipped word), "
                      f"{float(m.excluded_workers.max()):.0f} workers "
                      f"excluded, max |out - clean| {err:.3g}", flush=True)
            else:
                print(f"fault check {mode}, bare wire, flip_prob {p}: "
                      f"{int((~ok).sum())} non-finite coordinates of {d}, "
                      f"max |out - clean| over the finite ones {err:.3g}",
                      flush=True)


def sim_shapes(ops, ref, lv, cuda, out):
    """Each kernel at the shapes the simulator's topologies give it at
    phase G's width, against its plain version, timed in 3 rounds beside
    the plain version and the bound (records appended to ``out``): the
    param server's downlink on the 8-bit L-inf grid (int16 codes), a ring
    hop over all 4 workers' chunks, and the scenarios' buckets of 512,
    which take the shared-memory layout."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    cases = (  # buckets, bucket size, bits, norm, what
        (NB_B, BS_B, 8, "linf", "param-server downlink"),
        (NB_RING, BS_B, 3, "l2", "ring hop, 4 workers' chunks"),
        (D_B // 512 + 1, 512, 3, "l2", "buckets of 512 at phase G's d"))
    for nb, bs, bits, norm, what in cases:
        levels = lv.uniform_levels(bits, device=dev)
        L = levels.numel()
        vb = torch.randn(nb, bs, generator=g, device=dev) * 1e-3
        u = torch.rand(nb, bs, generator=g, device=dev)
        layout = label(cuda.bucket_launch(bs, 4, (vb.data_ptr(),
                                                  u.data_ptr(), 0)))
        check(layout == ("smem" if bs == 512 else
                         label(cuda.bucket_launch(BS_B, 4, (0,)))),
              f"{what}: layout {layout}")
        codes, norms = ops.quantize_op(vb, u, levels, norm_type=norm)
        parts, rows = chunks(nb)
        worst, mism = 0.0, 0
        for i in parts:
            c2, n2 = ref.quantize_ref(vb[i:i + rows], u[i:i + rows], levels,
                                      norm)
            check(bool(torch.allclose(norms[i:i + rows], n2, rtol=1e-5,
                                      atol=0)),
                  f"{what}: quantize norms beyond rtol 1e-5")
            worst = max(worst, float((norms[i:i + rows] - n2).abs().max()))
            mism += ref.code_mismatches(codes[i:i + rows], c2,
                                        vb[i:i + rows], u[i:i + rows], n2,
                                        levels)
            del c2, n2
        n, cb = nb * bs, codes.element_size()
        record_shape(out, "sim shape", "quantize",
                     f"({nb}, {bs}) f32 {norm} {bits}-bit",
                     lambda: ops.quantize_op(vb, u, levels, norm_type=norm),
                     lambda: [ref.quantize_ref(vb[i:i + rows], u[i:i + rows],
                                               levels, norm) for i in parts],
                     n * (8 + cb) + nb * 4, n * (20 + math.log2(L)), worst,
                     f"{what}, {codes.dtype} codes, {layout}, {mism} codes "
                     "off by one at ties")
        got = ops.dequantize_op(codes, norms, levels)
        for i in parts:
            check(torch.equal(got[i:i + rows], ref.dequantize_ref(
                codes[i:i + rows], norms[i:i + rows], levels)),
                f"{what}: dequantize not exact")
        del got
        record_shape(out, "sim shape", "dequantize",
                     f"({nb}, {bs}) {codes.dtype}",
                     lambda: ops.dequantize_op(codes, norms, levels),
                     lambda: [ref.dequantize_ref(codes[i:i + rows],
                                                 norms[i:i + rows], levels)
                              for i in parts],
                     n * (cb + 4) + nb * 4, n * 5, 0.0, what)
        del codes, norms
        if bs == 512:
            vals = ops.bucket_stats_op(vb)
            worst = 0.0
            for i in parts:
                for a, r in zip(vals, ref.bucket_stats_ref(vb[i:i + rows],
                                                           "l2")):
                    check(torch.allclose(a[i:i + rows], r, rtol=1e-5,
                                         atol=1e-7),
                          f"{what}: bucket_stats beyond rtol 1e-5")
                    worst = max(worst, float((a[i:i + rows] - r).abs().max()))
            del vals
            record_shape(out, "sim shape", "bucket_stats",
                         f"({nb}, {bs}) f32 l2",
                         lambda: ops.bucket_stats_op(vb),
                         lambda: [ref.bucket_stats_ref(vb[i:i + rows], "l2")
                                  for i in parts],
                         n * 4 + nb * 12, n * 8, worst, f"{what}, {layout}")
        del vb, u
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _sim_agree(name, gpu, cpu, scale, gap, bs, ring=False):
    """Card against CPU over (M, d) views: each coordinate within 1e-6 of
    its terms' scale (norms summed in another order differ in the last
    ulp) at >= 0.99999 of them; each other one within one level step of
    its scale, where a rounding tie went the other way.  On the ring a
    tie at one hop changes its chunk's bucket norm at every later hop:
    there whole buckets may differ, at most 1% of the (view, bucket)
    pairs, each within 2(M-1) level steps.  Returns (share of close
    coordinates, disagreeing coordinates or tie buckets, max abs diff)."""
    import torch
    gpu = gpu.cpu()
    check(gpu.shape == cpu.shape and bool(torch.isfinite(gpu).all()),
          f"{name}: output shape or finiteness")
    M, d = cpu.shape
    scale = scale.expand(M, d)
    err = (gpu - cpu).abs()
    close = err <= 1e-6 * scale + 1e-12
    frac = float(close.float().mean())
    far = ~close
    if ring:
        pad = -d % bs
        buckets = torch.nn.functional.pad(far, (0, pad)).view(M, -1, bs)
        ties = int(buckets.any(dim=2).sum())
        check(ties <= 0.01 * buckets.shape[0] * buckets.shape[1],
              f"{name}: {ties} (view, bucket) pairs differ")
        steps = 2 * (M - 1)
    else:
        ties = int(far.sum())
        check(frac >= 0.99999, f"{name}: card agrees with CPU at only "
                               f"{frac:.6f} of the coordinates")
        steps = 1
    check(bool((err[far] <= steps * gap * scale[far] + 1e-12).all()),
          f"{name}: a coordinate differs by more than {steps} level steps")
    return frac, ties, float(err.max())


def sim_check(topology, compress, QuantScheme, make_codec):
    """Each topology on the card against the CPU with the same gradients
    and uniforms (drawn on the CPU): aggregates by ``_sim_agree``, byte
    counts, hops and bits/coord equal, and the param server without a
    downlink grid equal to the allreduce bit for bit on the card."""
    import torch
    d, bs = 300_000, 1024
    scheme = QuantScheme(bits=3, bucket_size=bs)
    gap = float(torch.diff(scheme.init_levels("cpu")).max())
    g = torch.Generator().manual_seed(12)
    base = torch.randn(8, d, generator=g) * 1e-2
    residual = torch.randn(8, d, generator=g) * 3e-3
    mask, crash = (1.0, 0.0, 1.0, 1.0), (1.0, 0.5, 1.0, 0.0)
    cases = [  # name, workers, codec kind, active, server_bits, compress
        ("allreduce", 4, "uniform", None, 8, "plain"),
        ("param_server", 4, "uniform", None, 8, "plain"),
        ("param_server", 4, "uniform", None, None, "plain"),
        ("ring", 8, "uniform", None, 8, "plain"),
        *[(t, 4, "uniform", a, 8, "plain") for a in (mask, crash)
          for t in ("allreduce", "param_server", "ring")],
        *[(t, 4, k, None, 8, "plain") for k in ("mixed_width", "entropy")
          for t in ("allreduce", "param_server")],
        *[(t, 4, "uniform", None, 8, "ef")
          for t in ("allreduce", "param_server", "ring")],
    ]
    card_of, u_of = {}, {}
    for name, M, kind, active, sbits, spec in cases:
        algo = compress.make_algorithm(
            spec, scheme,
            codec=None if kind == "uniform" else make_codec(scheme, kind))
        c = algo.codec
        if name == "ring":
            plan = c.plan(d, shards=M)
            u = {"u_hops": [torch.rand((M,) + c.rounding_shape(
                plan.shard_nb), generator=g) for _ in range(2 * (M - 1))]}
        else:
            plan = c.plan(d)
            u = {"u": [torch.rand(c.rounding_shape(plan.nb), generator=g)
                       for _ in range(M)]}
            if name == "param_server" and sbits is not None:
                u["u_server"] = torch.rand(plan.nb, bs, generator=g)
        if name == "param_server" and sbits is None:
            u = u_of["allreduce"]       # the allreduce's encodes
        u_of.setdefault(name, u)
        grads = base[:M]
        out = {}
        for dev in ("cpu", "cuda"):
            st = algo.init_state(M, d, dev)
            if algo.stateful:
                st.residual.copy_(residual[:M])
            du = {k: ([[x.to(dev) for x in h] for h in v] if k == "u_hops"
                      else [x.to(dev) for x in v] if isinstance(v, list)
                      else v.to(dev)) for k, v in u.items()}
            # a copy: error feedback forms its input in the rows in place
            res, st = topology.run_compressed(
                name, grads.to(dev, copy=True), scheme,
                scheme.init_state(dev), algo, st, active=active,
                server_bits=sbits, **du)
            out[dev] = (res, st)
        (cpu, cst), (card, kst) = out["cpu"], out["cuda"]
        tag = (f"{name} M={M}{'' if kind == 'uniform' else ' ' + kind}"
               f"{'' if active is None else ' active ' + str(active)}"
               f"{'' if name != 'param_server' else f' server_bits {sbits}'}"
               f"{'' if spec == 'plain' else ' + ' + spec}")
        inp = grads + residual[:M] if algo.stateful else grads
        scale = _bucket_scale(inp, bs)
        frac, ties, worst = _sim_agree(tag, card.aggregate, cpu.aggregate,
                                       scale, gap, bs, ring=name == "ring")
        for f in ("sent_bytes", "recv_bytes", "wire_bits_per_coord"):
            check(bool((getattr(card, f) == getattr(cpu, f)).all()),
                  f"{tag}: {f} differ between card and CPU")
        check(card.server_bytes == cpu.server_bytes
              and card.hops == cpu.hops, f"{tag}: server bytes or hops")
        rtxt = ""
        if algo.stateful:
            rfrac, rties, _ = _sim_agree(f"{tag} residual", kst.residual,
                                         cst.residual, scale, gap, bs)
            rtxt = f", residuals {rfrac:.6f} within 1e-6"
        if active is None and kind == "uniform" and spec == "plain":
            card_of[name, sbits] = card.aggregate
        print(f"sim check {tag}: card vs CPU {frac:.6f} of coordinates "
              f"within 1e-6 of their scale, {ties} "
              f"{'tie buckets' if name == 'ring' else 'off at ties'}, max "
              f"abs diff {worst:.3g}{rtxt}; sent {card.sent_bytes[0]:.0f} "
              f"recv {card.recv_bytes[0]:.0f} server "
              f"{card.server_bytes:.0f} bytes, {card.hops} hops, equal",
              flush=True)
    check(torch.equal(card_of["param_server", None],
                      card_of["allreduce", 8]),
          "param_server without a downlink grid differs from the allreduce "
          "on the card")
    print("sim check: param_server (server_bits None) equals the allreduce "
          "bit for bit on the card", flush=True)


def scenario_check(sim_main, cuda):
    """``python -m repro_torch.sim`` through its ``main``: paper_mlp for 4
    steps twice on the card (identical JSON) and once on the CPU (the
    same bytes, hops, simulated times and fixed bits/coord); then
    fault_tolerance for 4 steps on both: the same crash/rejoin events,
    and corrupt buckets in the faulty cell with a finite loss."""
    outdir = os.path.join(ROOT, "build", "chip_smoke_sim")
    os.makedirs(outdir, exist_ok=True)

    def run(name, tag, device):
        path = os.path.join(outdir, f"{name}_{tag}.json")
        check(sim_main.main(["--scenario", name, "--steps", "4", "--out",
                             path, "--device", device]) == 0,
              f"python -m repro_torch.sim --scenario {name} failed")
        with open(path) as f:
            r = json.load(f)
        r.pop("wallclock_s")
        return r

    cuda.reset_launches()
    first = run("paper_mlp", "card1", "cuda")
    counts, layouts = dict(cuda.LAUNCHES), dict(cuda.LAYOUTS)
    check(all(counts.get(k, 0) > 0 for k in cuda.KERNELS),
          f"scenario paper_mlp launches {counts}")
    check(all(layouts.get(f"{k}/smem", 0) == counts[k]
              for k in ("quantize", "bucket_stats")),
          f"scenario buckets of 512 not in shared memory: {layouts}")
    second = run("paper_mlp", "card2", "cuda")
    check(json.dumps(first, sort_keys=True)
          == json.dumps(second, sort_keys=True),
          "paper_mlp: two runs on the card differ")
    cpu = run("paper_mlp", "cpu", "cpu")
    for a, c in zip(first["cells"], cpu["cells"]):
        check(a["fixed_bits_per_coord"] == c["fixed_bits_per_coord"],
              "paper_mlp fixed bits/coord")
        for sa, sc in zip(a["steps"], c["steps"]):
            for k in ("wire_sent_bytes", "wire_recv_bytes", "server_bytes",
                      "hops", "sim_time_ms"):
                check(sa[k] == sc[k], f"paper_mlp {a['scheme']} "
                      f"{a['topology']} step {sa['step']}: {k} card "
                      f"{sa[k]} CPU {sc[k]}")
            check(math.isfinite(sa["loss"]), "paper_mlp loss not finite")
    def finals(r):
        return [round(c["totals"]["final_loss"], 4) for c in r["cells"]]

    print(f"scenario check paper_mlp: 6 cells x 4 steps, two card runs "
          f"identical, bytes, hops, simulated times and fixed bits/coord "
          f"equal to the CPU's; launches {counts}, layouts {layouts}; final "
          f"losses card {finals(first)} CPU {finals(cpu)}", flush=True)
    card, cpu = run("fault_tolerance", "card", "cuda"), run(
        "fault_tolerance", "cpu", "cpu")
    for a, c in zip(card["cells"], cpu["cells"]):
        check(a["fault_events"] == c["fault_events"],
              "fault_tolerance: crash/rejoin events differ from the CPU's")
        check(all(math.isfinite(s["loss"]) for s in a["steps"]),
              "fault_tolerance loss not finite")
    faulty = [c for c in card["cells"] if c["fault"] is not None][0]
    cf = faulty["totals"]["mean_corrupt_fraction"]
    check(cf > 0, "fault_tolerance: no corrupt bucket in the faulty cell")
    print(f"scenario check fault_tolerance: events equal to the CPU's "
          f"({len(faulty['fault_events'])} in 4 steps), faulty cell corrupt "
          f"share {cf:.4f}, final loss {faulty['totals']['final_loss']:.4f} "
          f"(fault-free {card['cells'][0]['totals']['final_loss']:.4f})",
          flush=True)


def phase_g(sim, cuda):
    """Phase G: the simulator at phase B's width, one topology a run, the
    launch counts set to 0 just before each; returns topology -> (cell,
    launches, layouts, peak bytes).

    The port's attention is deterministic, so the three cells compute
    the same gradients at step 0: with the same uniforms, the allreduce
    and the param server encode the same uplinks (equal quant_error),
    and the little error the param server's 8-bit downlink adds shows in
    its agg_err."""
    import gc
    import torch
    out = {}
    for topo in ("allreduce", "param_server", "ring"):
        scn = sim.Scenario(
            name=f"phase_g_{topo}", arch="llama3.2-1b", layers=4,
            data="uniform", schemes=("alq",), topologies=(topo,), bits=3,
            bucket_size=BS_B, steps=3, batch_per_worker=2, seq_len=1024,
            lr=1e-4, update_milestones=(1,), server_bits=8,
            cluster=sim.ClusterConfig(num_workers=M_B))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cuda.reset_launches()
        res = sim.run_scenario(scn, device="cuda", time_stages=True)
        counts, layouts = dict(cuda.LAUNCHES), dict(cuda.LAYOUTS)
        peak = torch.cuda.max_memory_allocated()
        cell = res["cells"][0]
        check(all(math.isfinite(s["loss"]) for s in cell["steps"]),
              f"phase G {topo}: loss not finite")
        # the ring's hops requantize: no fused decode-and-average
        check(all(counts.get(k, 0) > 0 for k in cuda.KERNELS
                  if topo != "ring" or k != "dequantize_mean"),
              f"phase G {topo}: launches {counts}")
        for s in cell["steps"]:
            split = ", ".join(f"{k} {v:.1f}" for k, v in s["stage_ms"].items())
            print(f"phase G {topo} step {s['step']}: {s['step_ms']:.1f} "
                  f"ms/step; stages ms: {split}; loss {s['loss']:.4f}; "
                  f"sent {s['wire_sent_bytes'][0]:.0f} recv "
                  f"{s['wire_recv_bytes'][0]:.0f} server "
                  f"{s['server_bytes']:.0f} bytes a worker; sim_time "
                  f"{s['sim_time_ms']:.3f} ms; agg_err {s['agg_err']:.6g}; "
                  f"quant_error {s['quant_error']:.6g}", flush=True)
        print(f"phase G {topo}: peak memory {peak / 2**30:.2f} GiB, "
              f"launches {counts}, layouts {layouts}", flush=True)
        out[topo] = (cell, counts, layouts, peak)
    err = {t: c["steps"][0]["agg_err"] for t, (c, *_) in out.items()}
    qerr = {t: c["steps"][0]["quant_error"] for t, (c, *_) in out.items()}
    check(qerr["param_server"] == qerr["allreduce"],
          f"phase G: the param server's uplinks differ from the allreduce's "
          f"encodes at step 0 (quant_error {qerr})")
    check(err["ring"] > err["allreduce"],
          f"phase G: ring agg_err {err['ring']} not above the allreduce's "
          f"{err['allreduce']} at step 0")
    check(err["param_server"] > err["allreduce"],
          f"phase G: param_server agg_err {err['param_server']} not above "
          f"the allreduce's {err['allreduce']} at step 0")
    print(f"phase G: step-0 agg_err allreduce {err['allreduce']:.9g} < "
          f"param_server {err['param_server']:.9g}, ring {err['ring']:.9g} "
          f"(the same uplink encodes: quant_error {qerr['allreduce']:.9g})",
          flush=True)
    return out


@contextlib.contextmanager
def stage_peaks():
    """While open, every stage clock's mark also books the card's peak
    since the last mark to that stage (and restarts the peak counter);
    yields the stage -> peak bytes dict, whose last entry
    ``"after the last mark"`` holds what came after."""
    import torch
    from repro_torch import timing
    peaks: dict[str, int] = {}
    mark = timing.StageClock.mark

    def book(stage):
        p = torch.cuda.max_memory_allocated()
        peaks[stage] = max(peaks.get(stage, 0), p)
        torch.cuda.reset_peak_memory_stats()

    def marked(self, stage):
        mark(self, stage)
        book(stage)

    timing.StageClock.mark = marked
    try:
        yield peaks
    finally:
        timing.StageClock.mark = mark
        book("after the last mark")


def run_phase(train, name, argv, kernels_needed, cuda, d=D_B):
    """One training run through the launcher with every launch count set
    to 0 just before it; returns (result, launches, layouts, peak) and
    keeps the stage that held the peak in ``res["peak_stage"]``."""
    import torch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    PEAK_BASE[name] = torch.cuda.memory_allocated()
    cuda.reset_launches()
    with stage_peaks() as peaks:
        res = train.run(train.parse_args(argv))
        counts, layouts = dict(cuda.LAUNCHES), dict(cuda.LAYOUTS)
    peak = max(peaks.values())
    res["peak_stage"] = max(peaks, key=peaks.get)
    res["stage_peaks"] = peaks
    del res["trainer"]  # free the phase's model and state for the next
    check(res["d"] == d, f"phase {name} d = {res['d']}, expected {d}")
    hist = res["history"]
    check(all(math.isfinite(h["loss"]) for h in hist),
          f"phase {name} loss not finite")
    check(all(counts.get(k, 0) > 0 for k in kernels_needed),
          f"phase {name} kernel launches {counts}")
    for h in hist:
        split = ", ".join(f"{k} {v:.1f}" for k, v in h["stage_ms"].items())
        print(f"phase {name} step {h['step']}: {h['step_ms']:.1f} ms/step; "
              f"stages ms: {split}; loss {h['loss']:.4f}", flush=True)
    top = ", ".join(f"{k} {v / 2**30:.2f}" for k, v in sorted(
        peaks.items(), key=lambda kv: -kv[1])[:4])
    print(f"phase {name}: peak memory {peak / 2**30:.2f} GiB in stage "
          f"{res['peak_stage']} (the highest stages, GiB: {top})",
          flush=True)
    return res, counts, layouts, peak


def phase_shapes(ops, ref, lv, out, phase, nb, m=M_B):
    """Each kernel at the shapes a full-width phase gives it (``nb``
    buckets of 8192 a worker, ``m`` workers: phase H's qwen3-0.6b, d =
    751,632,384 in 91,752 buckets; phase I's rwkv6-7b at 2 layers, d =
    1,058,099,200 in 129,163; phase P's model rank of qwen3-0.6b at tp =
    2, d = 405,209,088 in 49,464, 2 data workers), against its plain
    version, timed in 3 rounds beside the plain version and the bound
    (records appended to ``out``)."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(12)
    levels = lv.uniform_levels(3, device=dev)
    L = levels.numel()
    vb = torch.randn(nb, BS_B, generator=g, device=dev) * 1e-3
    u = torch.rand(nb, BS_B, generator=g, device=dev)
    codes, norms = ops.quantize_op(vb, u, levels)
    parts, rows = chunks(nb)
    worst, mism = 0.0, 0
    for i in parts:
        c2, n2 = ref.quantize_ref(vb[i:i + rows], u[i:i + rows], levels, "l2")
        check(bool(torch.allclose(norms[i:i + rows], n2, rtol=1e-5, atol=0)),
              f"quantize norms at phase {phase}'s shape beyond rtol 1e-5")
        worst = max(worst, float((norms[i:i + rows] - n2).abs().max()))
        mism += ref.code_mismatches(codes[i:i + rows], c2, vb[i:i + rows],
                                    u[i:i + rows], n2, levels)
        del c2, n2
    del codes, norms
    n = nb * BS_B
    record_shape(out, f"phase {phase} shape", "quantize",
                 f"({nb}, {BS_B}) f32 l2 3-bit",
                 lambda: ops.quantize_op(vb, u, levels),
                 lambda: [ref.quantize_ref(vb[i:i + rows], u[i:i + rows],
                                           levels, "l2") for i in parts],
                 n * 9 + nb * 4, n * (20 + math.log2(L)), worst,
                 f"encode of one worker, int8 codes, {mism} codes off by "
                 "one at ties")
    vals = ops.bucket_stats_op(vb)
    worst = 0.0
    for i in parts:
        for a, r in zip(vals, ref.bucket_stats_ref(vb[i:i + rows], "l2")):
            check(torch.allclose(a[i:i + rows], r, rtol=1e-5, atol=1e-7),
                  f"bucket_stats at phase {phase}'s shape beyond rtol 1e-5")
            worst = max(worst, float((a[i:i + rows] - r).abs().max()))
    del vals
    record_shape(out, f"phase {phase} shape", "bucket_stats",
                 f"({nb}, {BS_B}) f32 l2", lambda: ops.bucket_stats_op(vb),
                 lambda: [ref.bucket_stats_ref(vb[i:i + rows], "l2")
                          for i in parts],
                 n * 4 + nb * 12, n * 8, worst, "stats of one worker")
    del vb, u
    c32 = torch.randint(-(L - 1), L, (m * nb, BS_B), generator=g,
                        device=dev, dtype=torch.int32)
    n4 = torch.rand(m * nb, generator=g, device=dev) + 0.1
    got = ops.dequantize_op(c32, n4, levels)
    parts, rows = chunks(m * nb, 32)
    for i in parts:
        check(torch.equal(got[i:i + rows], ref.dequantize_ref(
            c32[i:i + rows], n4[i:i + rows], levels)),
            f"dequantize at phase {phase}'s shape not exact")
    del got
    record_shape(out, f"phase {phase} shape", "dequantize",
                 f"({m * nb}, {BS_B}) int32",
                 lambda: ops.dequantize_op(c32, n4, levels),
                 lambda: [ref.dequantize_ref(c32[i:i + rows], n4[i:i + rows],
                                             levels) for i in parts],
                 m * n * 8 + m * nb * 4, m * n * 5, 0.0,
                 f"the {m} gathered streams, as decoded before the fused "
                 "mean")
    del c32, n4
    c8, n8 = mean_inputs(m, nb, levels, g)
    got = ops.dequantize_mean_op(c8, n8, levels)
    parts, rows = chunks(nb, 16)
    for i in parts:
        want = ref.dequantize_mean_ref(c8[:, i:i + rows], n8[:, i:i + rows],
                                       levels)
        check(torch.equal(f32_bits(got[i:i + rows]), f32_bits(want)),
              f"dequantize_mean at phase {phase}'s shape not bit-equal")
    del got
    record_shape(out, f"phase {phase} shape", "dequantize_mean",
                 f"({m}, {nb}, {BS_B}) int8",
                 lambda: ops.dequantize_mean_op(c8, n8, levels),
                 lambda: [ref.dequantize_mean_ref(
                     c8[:, i:i + rows], n8[:, i:i + rows], levels)
                     for i in parts],
                 mean_bytes(m, nb, BS_B), m * n * 6, 0.0,
                 f"decode and mean of the {m} gathered streams")
    del c8, n8
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def api_check(core, ref, lv, cuda):
    """``repro_torch.core``'s encode, decode and quantize on the card go
    through the kernels (the launch counts move) and match the plain
    versions on the same tensors; norms rtol 1e-5, codes equal except
    off by one at rounding ties, decode exact."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)
    d, bs = 300_001, 1024
    nb = -(-d // bs)
    v = torch.randn(d, generator=g, device=dev) * 1e-2
    u = torch.rand(nb, bs, generator=g, device=dev)
    vb = core.pad_to_buckets(v, bs)
    mism = 0
    for bits, norm in ((3, "l2"), (8, "linf")):
        levels = lv.uniform_levels(bits, device=dev)
        cuda.reset_launches()
        qt = core.encode(v, levels, u, bucket_size=bs, norm_type=norm)
        out = core.decode(qt, levels)
        q = core.quantize(v, levels, u, bucket_size=bs, norm_type=norm)
        counts = dict(cuda.LAUNCHES)
        check(counts.get("quantize") == 2 and counts.get("dequantize") == 2,
              f"core API on the card: launches {counts}")
        c2, n2 = ref.quantize_ref(vb, u, levels, norm)
        check(qt.dim == d and qt.codes.dtype == c2.dtype,
              "core.encode on the card: dim or code dtype")
        check(bool(torch.allclose(qt.norms, n2, rtol=1e-5, atol=0)),
              f"core.encode on the card: norms beyond rtol 1e-5 ({norm})")
        mism += ref.code_mismatches(qt.codes, c2, vb, u, n2, levels)
        check(torch.equal(out, ref.dequantize_ref(
            qt.codes, qt.norms, levels).reshape(-1)[:d]),
            "core.decode on the card not exact")
        check(torch.equal(q, out), "core.quantize differs from decode(encode)")
    print(f"API check: core.encode/decode/quantize on the card (d = {d}, "
          f"buckets of {bs}, 3-bit l2 and 8-bit linf) match the plain "
          f"versions, {mism} codes off by one at ties, launches {counts}",
          flush=True)


@contextlib.contextmanager
def float64_everywhere():
    """The port's float32 casts and default dtype as float64, for an
    evaluation of the same formulas in float64."""
    import torch
    from unittest import mock
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        with mock.patch.object(torch.Tensor, "float", torch.Tensor.double):
            yield
    finally:
        torch.set_default_dtype(default)


def config_check(train, configs, Model, cuda, label, cases, archs,
                 loss_rtol, grad_rtol, prepare=False):
    """Each (name, config) of ``cases``: one forward and backward pass of
    2 x 1024 tokens on the card and on the CPU with the same weights
    (with ``prepare``, drawn by ``trained_like``; both gradients are also
    measured against a float64 evaluation of the same formulas on the
    card, and a control computed in bfloat16 on the card must read above
    ``grad_rtol``, so that the band tells a lower precision apart) and,
    for a VLM, the same image embeddings (losses within ``loss_rtol``,
    flat gradients within ``grad_rtol`` of their largest entry); then 4
    quantized steps of each of ``archs``'s SMOKE configs
    through the launcher's ``--smoke`` on the card.  Returns each
    ``--smoke`` run's launches."""
    import dataclasses
    import numpy as np
    import torch
    toks = np.random.default_rng(14).integers(0, 509, (2, 1025))
    for name, cfg in cases:
        ids = torch.from_numpy(toks % cfg.vocab_size)
        on_cpu = Model(cfg, device="cpu", seed=0)
        gen = torch.Generator().manual_seed(14)
        if prepare:
            trained_like(on_cpu, gen)
        vision = (torch.randn(2, cfg.num_image_tokens, cfg.d_model,
                              generator=gen)
                  if cfg.cross_attn_every else None)
        on_card = Model(cfg, device="cuda", seed=0)
        on_card.load_flat(on_cpu.flat.cuda())
        models = [on_cpu, on_card]
        if prepare:
            exact = Model(dataclasses.replace(
                cfg, param_dtype="float64", compute_dtype="float64"),
                device="cuda", seed=0)
            exact.load_flat(on_cpu.flat.double().cuda())
            control = Model(dataclasses.replace(cfg, compute_dtype="bfloat16"),
                            device="cuda", seed=0)
            control.load_flat(on_cpu.flat.cuda())
            models += [exact, control]
        res = []
        for model in models:
            grad = torch.zeros_like(model.flat)
            model.attach_grads(grad)
            dev = model.flat.device
            x = ids.to(dev)
            with (float64_everywhere() if model.flat.dtype == torch.float64
                  else contextlib.nullcontext()):
                loss = model.loss(
                    x[:, :-1], x[:, 1:], None if vision is None
                    else vision.to(dev, model.flat.dtype))
                loss.backward()
            res.append((loss.item(), grad.cpu()))
        (lc, gc), (lg, gg) = res[:2]
        rel = abs(lg - lc) / abs(lc)
        gerr = float((gg - gc).abs().max() / gc.abs().max())
        check(rel <= loss_rtol, f"{label} check {name}: loss card {lg} CPU "
              f"{lc}")
        check(gerr <= grad_rtol, f"{label} check {name}: gradient off by "
              f"{gerr} of its largest entry")
        f64 = ""
        if prepare:
            g64 = res[2][1]
            off = [float((g.double() - g64).abs().max() / g64.abs().max())
                   for g in (gc, gg)]
            ctrl = float((res[3][1] - gc).abs().max() / gc.abs().max())
            check(max(off) <= grad_rtol, f"{label} check {name}: float32 "
                  f"gradients off float64 by {off}")
            check(ctrl > grad_rtol, f"{label} check {name}: the bfloat16 "
                  f"control reads {ctrl}, inside the band {grad_rtol}")
            f64 = (f"; against float64 on the card: CPU {off[0]:.2g}, card "
                   f"{off[1]:.2g}; the bfloat16 control {ctrl:.2g}")
        print(f"{label} check {name}: loss card {lg:.6f} CPU {lc:.6f} (rel "
              f"{rel:.2g}), gradient within {gerr:.2g} of its largest entry"
              f"{f64}", flush=True)
        del models, on_cpu, on_card, res
    launches = {}
    for arch in archs:
        cuda.reset_launches()
        res = train.run(train.parse_args([
            "--arch", arch, "--smoke", "--workers", str(M_B), "--batch", "8",
            "--seq", "128", "--steps", "4", "--update-at", "1", "--bucket",
            "1024"]))
        counts = launches[arch] = dict(cuda.LAUNCHES)
        losses = [h["loss"] for h in res["history"]]
        check(all(math.isfinite(x) for x in losses),
              f"--smoke {arch}: losses {losses}")
        check(all(counts.get(k, 0) > 0 for k in cuda.KERNELS),
              f"--smoke {arch}: launches {counts}")
        print(f"--smoke {arch}: {res['config'].name}, d={res['d']}, 4 steps, "
              f"losses {[round(x, 4) for x in losses]}, launches {counts}",
              flush=True)
    return launches


def dense_config_check(train, configs, Model, cuda):
    """Each new SMOKE config of the dense family, and llama3.2's with a
    sliding window and with chunks (a partial trailing chunk): losses at
    rtol 1e-5, gradients within 1e-4 of their largest entry."""
    import dataclasses
    cases = [(a, configs.get_smoke_config(a)) for a in NEW_ARCHS]
    llama = configs.get_smoke_config("llama3.2-1b")
    cases += [("llama3.2 sliding 256", dataclasses.replace(
                  llama, attn_kind="sliding", window=256)),
              ("llama3.2 chunked 384", dataclasses.replace(
                  llama, attn_kind="chunked", chunk=384))]
    config_check(train, configs, Model, cuda, "dense", cases, NEW_ARCHS,
                 1e-5, 1e-4)


def moe_rwkv_config_check(train, configs, Model, cuda):
    """The mixtral, llama4-scout and rwkv6 SMOKE configs (float32: top-2
    routing, top-1 with the shared expert, the RWKV6 chunk loop), the loss
    with the aux loss: losses within 1e-6, gradients within 1e-5 of their
    largest entry."""
    cases = [(a, configs.get_smoke_config(a)) for a in MOE_RWKV_ARCHS]
    config_check(train, configs, Model, cuda, "moe/rwkv", cases,
                 MOE_RWKV_ARCHS, 1e-6, 1e-5)


def hybrid_vlm_config_check(train, configs, Model, cuda):
    """The jamba and llama-vision SMOKE configs (float32: Mamba mixers,
    attention every 8th layer and MoE every 2nd; cross-attention on the
    5th layer over 16 image embeddings), with ``trained_like`` weights
    (open conv and gate): losses within 1e-6, gradients within 1e-5 of
    their largest entry for the VLM and 5e-5 for jamba, whose 8 layers'
    float32 gradient is itself ~2e-5 of its largest entry off a float64
    evaluation (printed: the card's and the CPU's, each against float64,
    and a bfloat16 control's reading, far above either band);
    then 4 steps of each through ``--smoke`` (which, as the reference's
    launcher, passes no image embeddings).  Returns the ``--smoke`` runs'
    launches."""
    launches = {}
    for arch, band in ((JAMBA, 5e-5), (VLM, 1e-5)):
        launches.update(config_check(
            train, configs, Model, cuda, "hybrid/vlm",
            [(arch, configs.get_smoke_config(arch))], (arch,), 1e-6, band,
            prepare=True))
    return launches


def vision_step_check(configs, Model, cuda):
    """One train step of llama-vision-smoke with 4 workers and the
    pipeline's image embeddings (8 x 128 tokens, 16 embeddings a
    sequence, split over the workers as the ids are), on the card against
    the CPU: the same ``trained_like`` weights (an open gate), batch,
    embeddings and uniforms; ALQ 3-bit, buckets of 1024, a level update
    at step 0, SGD at lr 0.5.  Loss within 1e-6, the workers' gradient
    rows within 1e-5 of their largest entry, levels within 1e-4 (ALQ's
    coordinate descent), and each parameter's move within lr x its
    bucket's norm x (the levels' difference + 1e-5) at 99.5% of the
    coordinates (the rest: a rounding tie, one level step off).  Returns
    the card step's launches."""
    import torch
    from repro_torch.core.codec import codec_for_scheme
    from repro_torch.core.schemes import QuantScheme
    from repro_torch.train.data import DataConfig, Pipeline
    from repro_torch.train.optim import OptimConfig
    from repro_torch.train.train_step import TrainConfig, Trainer
    cfg = configs.get_smoke_config(VLM)
    scheme = QuantScheme(name="alq", bits=3, bucket_size=1024)
    pipe = Pipeline(DataConfig(kind="markov", vocab_size=cfg.vocab_size,
                               seq_len=128, global_batch=8))
    batch = dict(pipe.batch(0, "cpu"), vision=pipe.vision_stub(
        cfg.num_image_tokens, cfg.d_model, 0, "cpu"))
    on_cpu = Model(cfg, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(19)
    trained_like(on_cpu, gen)
    p0 = on_cpu.flat.clone()
    on_card = Model(cfg, device="cuda", seed=0)
    on_card.load_flat(p0.cuda())
    plan = codec_for_scheme(scheme).plan(on_cpu.d)
    u = [torch.rand(plan.nb, plan.bucket_size, generator=gen)
         for _ in range(M_B)]
    out = {}
    for dev, model in (("cpu", on_cpu), ("cuda", on_card)):
        trainer = Trainer(model, TrainConfig(
            scheme=scheme, optim=OptimConfig(name="sgdm", lr=0.5,
                                             weight_decay=0.0),
            update_milestones=(0,), update_every=0, workers=M_B))
        cuda.reset_launches()
        m = trainer.train_step({k: v.to(dev) for k, v in batch.items()},
                               u=[x.to(dev) for x in u])
        out[dev] = (m, trainer, dict(cuda.LAUNCHES))
    (mc, tc, _), (mg, tg, counts) = out["cpu"], out["cuda"]
    rel = abs(mg["loss"] - mc["loss"]) / abs(mc["loss"])
    gerr = float((tg.grads.cpu() - tc.grads).abs().max()
                 / tc.grads.abs().max())
    lv, lc = tg.scheme_state.levels.cpu(), tc.scheme_state.levels
    dlev = float((lv - lc).abs().max())
    g = torch.nn.functional.pad(tc.grads, (0, plan.n - on_cpu.d))
    scale = (0.5 * torch.linalg.vector_norm(g.reshape(M_B, plan.nb, -1),
                                            dim=2).amax(0)
             ).repeat_interleave(plan.bucket_size)[:on_cpu.d]
    diff = ((on_card.flat.cpu() - p0) - (on_cpu.flat - p0)).abs()
    close = float((diff <= scale * (dlev + 1e-5)).float().mean())
    tie = bool((diff <= scale * (float(lc.diff().max()) + dlev + 1e-5)).all())
    cross = max(float(p.grad.abs().max())
                for p in on_card.layers[4].cross.values())
    check(rel <= 1e-6 and gerr <= 1e-5 and dlev <= 1e-4 and close >= 0.995
          and tie and cross > 0,
          f"vision step check: loss rel {rel}, gradient {gerr}, levels "
          f"{dlev}, moves within bound at {close}, all within a level step "
          f"{tie}, cross gradient {cross}")
    check(all(counts.get(k, 0) > 0 for k in cuda.KERNELS),
          f"vision step check: launches {counts}")
    print(f"vision step check: {cfg.name}, 4 workers x 2 x 128 tokens + 16 "
          f"image embeddings, d={on_cpu.d}: loss card {mg['loss']:.6f} CPU "
          f"{mc['loss']:.6f} (rel {rel:.2g}), gradient rows within "
          f"{gerr:.2g} of their largest entry, levels within {dlev:.2g}, "
          f"{close:.6f} of the moves within bound, cross-attention gradient "
          f"max {cross:.3g}, launches {counts}", flush=True)
    del out, tc, tg, on_cpu, on_card
    return counts


def trained_like(model, gen) -> None:
    """The leaves whose init hides the math, as a trained model has them.
    RWKV6's time-mix: token-shift mixes in [0, 1], w0 in [-4, -0.5] and
    the LoRA's B at a fifth of its scale, so that the log decays stay
    within -0.01 to -1 a token (the init's zero mixes and w0 let some
    channel of 2 x 1024 random tokens overflow the reference's masked
    ``exp(diff)``, and the gradient then holds NaN in both packages).
    Mamba's conv weights and bias, zero at init (the mixer's output would
    be exactly 0), normal at half scale; the VLM's cross gate, zero at
    init (the block would be shut), in [0.5, 1].  Other archs have none
    of these leaves, and their draws are unchanged."""
    import torch
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.startswith("mu_"):
                p.uniform_(0.0, 1.0, generator=gen)
            elif leaf == "w0":
                p.uniform_(-4.0, -0.5, generator=gen)
            elif leaf == "w_lora_b":
                p.mul_(0.2)
            elif leaf in ("conv_w", "conv_b"):
                p.copy_(torch.randn(p.shape, generator=gen,
                                    device=p.device) * 0.5)
            elif leaf == "gate":
                p.uniform_(0.5, 1.0, generator=gen)


def mamba_slot(configs):
    """jamba-1.5-large's layer slot 0 at full width: the Mamba mixer
    (d_inner 16384, d_state 16, dt_rank 512, conv 4) and the dense SwiGLU
    FFN (d_ff 24576), 1,024,327,680 parameters in a bfloat16 buffer of
    its own (the config's param_dtype).  Returns (config, buffer, layer);
    no train step of the model fits one card (ROADMAP section 1 item
    10)."""
    import torch
    from repro_torch.models import transformer
    cfg = configs.get_config(JAMBA)
    flat, views = transformer.init_flat(transformer.slot_layout(cfg, 0),
                                        getattr(torch, cfg.param_dtype),
                                        "cuda", 0)
    return cfg, flat, transformer.DecoderLayer(cfg, views, 0)


def twice_case(configs, Model, case):
    """(what it is, module, its flat parameters, a loss function) of
    ``grad_twice``: for ``MAMBA_SLOT`` jamba's slot 0 on 2 x 1024
    bfloat16 hidden states (the loss <y, dy> / n for a fixed random dy);
    else the arch ``case`` at full width, one group of layers (one layer;
    five for the VLM, whose fifth holds the cross-attention, fed 2 x 1601
    image embeddings), 2 x 1024 tokens.  Weights by ``trained_like``; all
    inputs from seed 15."""
    import dataclasses
    import torch
    g = torch.Generator(device="cuda").manual_seed(15)
    if case == MAMBA_SLOT:
        cfg, flat, layer = mamba_slot(configs)
        trained_like(layer, g)
        x, dy = (torch.randn(2, 1024, cfg.d_model, generator=g,
                             device="cuda") for _ in range(2))
        x = x.to(torch.bfloat16)

        def loss():
            return (layer(x)[0].float() * dy).mean()

        return (f"{JAMBA} slot 0 (Mamba + FFN, bf16), 2 x 1024 hidden "
                "states", layer, flat, loss)
    base = configs.get_config(case)
    cfg = dataclasses.replace(base, num_layers=base.group_size)
    model = Model(cfg, device="cuda", seed=0)
    trained_like(model, g)
    ids = torch.randint(0, cfg.vocab_size, (2, 1025), generator=g,
                        device="cuda")
    vision = (torch.randn(2, cfg.num_image_tokens, cfg.d_model, generator=g,
                          device="cuda") if cfg.cross_attn_every else None)

    def loss():
        return model.loss(ids[:, :-1], ids[:, 1:], vision)

    return (f"{case} width, {cfg.num_layers} layer(s), 2 x 1024 tokens",
            model, model.flat, loss)


def grad_twice(configs, Model, case, first_pass=None, profile=""):
    """Two forward and backward passes of ``twice_case(case)`` on the same
    weights and inputs, the first inside ``first_pass()`` where one is
    given (a context that may spy on the model); with ``profile``, a third
    under ``profile_step``.  Returns (both gradients finite and bit-equal,
    with the losses; max abs difference; the second pass's ms and added
    peak bytes; the loss; the profile or None; what the case is)."""
    import torch
    from repro_torch.models.transformer import attach_grads
    what, module, flat, loss_fn = twice_case(configs, Model, case)
    grads, losses = [], []
    for i in range(2):
        grad = torch.zeros_like(flat)
        attach_grads(module, flat, grad)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with (first_pass() if first_pass and i == 0
              else contextlib.nullcontext()):
            loss = loss_fn()
        loss.backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        added = torch.cuda.max_memory_allocated() - base
        losses.append(loss.item())
        grads.append(grad)
    same = (bool(torch.isfinite(grads[0]).all()) and math.isfinite(losses[0])
            and torch.equal(*grads) and losses[0] == losses[1])
    diff = float((grads[0] - grads[1]).abs().max())
    del grads
    prof = None
    if profile:
        attach_grads(module, flat, torch.zeros_like(flat))

        def step():
            loss_fn().backward()
            torch.cuda.synchronize()

        prof = profile_step(step, profile)
    del module, flat, loss_fn
    torch.cuda.empty_cache()
    return same, diff, ms, added, losses[0], prof, what


def determinism_check(configs, Model, case, first_pass=None, profile=""):
    """``grad_twice`` as the entry points run it, and again in a
    subprocess (``chip_smoke.py --grad-twice CASE``) under
    ``torch.use_deterministic_algorithms(True)``, which refuses any op on
    the path that has no deterministic implementation."""
    same, diff, ms, added, loss, prof, what = grad_twice(
        configs, Model, case, first_pass, profile)
    check(same, f"determinism check ({case}): two backward passes differ "
          f"by {diff} or are not finite")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    sub = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--grad-twice", case], env=env,
                         capture_output=True, text=True)
    check(sub.returncode == 0, f"determinism check ({case}) under "
          f"deterministic algorithms failed: {sub.stderr[-2000:]}")
    print(f"determinism check: {what}: loss {loss:.6g}; two backward "
          f"passes finite and bit-equal (second {ms:.1f} ms, "
          f"+{added / 2**30:.2f} GiB); under deterministic algorithms: "
          f"{sub.stdout.strip()}", flush=True)
    return {"ms": ms, "added_bytes": added, "loss": loss,
            "deterministic": sub.stdout.strip(), "profile": prof}


def moe_width_check(configs, Model):
    """``determinism_check`` of mixtral-8x7b at full width, one layer (8
    experts of d_ff 14336, top-2, bf16 compute), whose first pass goes
    through a spy that reads the MoE layer's aux loss, capacity, dropped
    share and expert loads: a finite aux loss at capacity 640."""
    import torch
    from repro_torch.models import moe, transformer
    stats = []

    def spy(cfg, p, x, *tp_ctx):
        y, aux = moe.moe_ffn(cfg, p, x, *tp_ctx)
        with torch.no_grad():
            xt = x.reshape(-1, x.shape[-1])
            probs = torch.softmax((xt @ p["router"]).float(), dim=-1)
            _, expert = moe.route(cfg, probs)
            C = moe.capacity(cfg, xt.shape[0])
            _, keep, counts = moe.dispatch_positions(expert,
                                                     cfg.num_experts, C)
        stats.append({"aux": aux.item(), "capacity": C,
                      "dropped_share": 1 - keep.float().mean().item(),
                      "loads": counts.tolist()})
        return y, aux

    @contextlib.contextmanager
    def first_pass():
        transformer.moe_ffn, orig = spy, transformer.moe_ffn
        try:
            yield
        finally:
            transformer.moe_ffn = orig

    res = determinism_check(configs, Model, "mixtral-8x7b", first_pass)
    check(len(stats) == 1 and math.isfinite(stats[0]["aux"])
          and stats[0]["capacity"] == 640, f"moe width check: {stats}")
    st = stats[0]
    print(f"moe width check: mixtral-8x7b width, 1 layer: aux "
          f"{st['aux']:.6g}, capacity {st['capacity']}, dropped share "
          f"{st['dropped_share']:.6f}, expert loads {st['loads']}",
          flush=True)
    return dict(res, layers=stats)


def attention_timing(attention):
    """The port's blockwise attention (``_flash``, as a layer calls it:
    bf16 q, k, v of (2, 1024, heads, head_dim), kv heads expanded)
    against one ``F.scaled_dot_product_attention`` call on the same
    inputs in float32 (PyTorch's choice of backend, which the port used
    before; not deterministic in backward), forward and backward, at
    phase B's and phase H's layer shapes: ms (median of 3 rounds of 10)
    and the peak memory each adds."""
    import torch
    import torch.nn.functional as F
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(16)
    out = {}
    for name, H, hd in (("B", 32, 64), ("H", 16, 128)):
        q, k, v, dy = (torch.randn(2, 1024, H, hd, generator=g, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        for t in (q, k, v):
            t.requires_grad_()

        def flash():
            y = attention._flash(q, k, v, causal=True, window=0)
            y.backward(dy)

        def sdpa():
            y = F.scaled_dot_product_attention(
                *(t.transpose(1, 2).float() for t in (q, k, v)),
                is_causal=True).transpose(1, 2).to(torch.bfloat16)
            y.backward(dy)

        ts = timed_rounds({"blockwise": flash, "sdpa": sdpa}, 10)
        mem = {}
        for key, fn in (("blockwise", flash), ("sdpa", sdpa)):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
            mem[key] = (torch.cuda.max_memory_allocated() - base) / 2**20
        out[name] = {k: {"ms": ts[k][0], "spread": ts[k][1],
                         "peak_mib": mem[k]} for k in ts}
        print(f"attention phase {name} layer (2, 1024, {H} heads, head_dim "
              f"{hd}), forward + backward: blockwise {ts['blockwise'][0]:.3f}"
              f" ms (spread {ts['blockwise'][1]:.3f}, +{mem['blockwise']:.0f}"
              f" MiB), one sdpa call in float32 {ts['sdpa'][0]:.3f} ms "
              f"(spread {ts['sdpa'][1]:.3f}, +{mem['sdpa']:.0f} MiB)",
              flush=True)
        del q, k, v, dy
    torch.cuda.empty_cache()
    return out


def profile_step(step, label):
    """``step()`` (a forward and backward, or a decode step; synchronised)
    twice on the host clock, then once under ``torch.profiler``:
    host-clock ms, the device's busy time (kernel time summed), its idle
    share of the host-clock time, the launches, and the ops that take the
    most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    step()
    t0 = time.perf_counter()
    step()
    host_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    top = sorted((e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CPU),
                 key=lambda e: -e.self_device_time_total)
    top = [(e.key, e.self_device_time_total / 1e3, e.count) for e in top[:8]]
    if not kernels:   # the profiler saw no device activity
        print(f"profile ({label}): {host_ms:.1f} ms host clock; device "
              "time not measured (the profiler recorded no kernel)",
              flush=True)
        return {"host_ms": host_ms}
    res = {"host_ms": host_ms, "busy_ms": busy_ms,
           "idle_share": 1 - busy_ms / host_ms, "launches": len(kernels),
           "top": top}
    print(f"profile ({label}): {host_ms:.1f} ms host clock, device busy "
          f"{busy_ms:.1f} ms (idle {res['idle_share']:.0%}), {len(kernels)} "
          "kernels; most device time: " + "; ".join(
              f"{k} {t:.1f} ms x{c}" for k, t, c in top), flush=True)
    return res


def grad_profile(Model, cfg, label):
    """``profile_step`` of one worker's forward and backward in a phase's
    model (``cfg``, 2 x 1024 tokens)."""
    import torch
    model = Model(cfg, device="cuda", seed=0)
    g = torch.Generator(device="cuda").manual_seed(17)
    ids = torch.randint(0, cfg.vocab_size, (2, 1025), generator=g,
                        device="cuda")
    model.attach_grads(torch.zeros(model.d, device="cuda"))

    def step():
        model.loss(ids[:, :-1], ids[:, 1:]).backward()
        torch.cuda.synchronize()

    res = profile_step(step, f"grad of {label}, one worker, 2 x 1024")
    del model
    torch.cuda.empty_cache()
    return res


def _max_rel(got, want) -> float:
    """max |got - want| over want's largest entry (both moved to the CPU,
    in float64)."""
    want = want.detach().double().cpu()
    return float((got.detach().double().cpu() - want).abs().max()
                 / want.abs().max())


def _steps_off(got, want) -> tuple[float, float]:
    """Two ``_serve_steps`` runs: the largest ``_max_rel`` of the logits
    and of any cache leaf, over the steps."""
    lerr = max(_max_rel(lg, lw) for (lg, _), (lw, _) in zip(got, want))
    cerr = max(_max_rel(a, b) for (_, cg), (_, cw) in zip(got, want)
               for x, y in zip(cg, cw) for a, b in zip(x, y))
    return lerr, cerr


def _shards(model) -> int:
    """The model's cache shards: the sizes of its ``seq_shard_axes``
    groups multiplied (1 at tp = 1 on one rank; ``decode``'s default)."""
    from repro_torch.models.layers import shard_of
    return shard_of(model.seq_ctxs)[0]


def _serve_steps(model, ids, vision, prompt, steps, max_len):
    """The prefill of ``ids[:, :prompt]`` and ``steps`` decode steps fed
    ``ids``'s next tokens (teacher forcing): [(logits, caches) after the
    prefill and after each step], copied to the CPU (a copy even of a
    CPU run's caches, which the next step updates in place)."""
    import torch

    def keep(logits, caches):   # copies: decode updates caches in place
        return logits.cpu(), [tuple(t.to("cpu", copy=True) for t in c)
                              for c in caches]

    logits, caches = model.prefill(ids[:, :prompt], vision, max_len=max_len,
                                   cache_shards=_shards(model))
    out = [keep(logits, caches)]
    for t in range(prompt, prompt + steps):
        pos = torch.full((ids.shape[0],), t, dtype=torch.int32,
                         device=ids.device)
        logits, caches = model.decode(ids[:, t], pos, caches, vision)
        out.append(keep(logits, caches))
    return out


def init_decays_against_float64(configs, Model):
    """rwkv6's SMOKE config (float32) with weights from seed 0, its
    token-shift mixes drawn in [0, 1] as ``trained_like`` draws them and
    its decays (w0 and the LoRA) as initialised: a prefill of 2 x 64 and
    4 teacher-forced decode steps on the CPU, on the card, and on the
    card in float64 (the same formulas, ``float64_everywhere``).  Returns
    (logits, caches) errors over their largest entry (``_steps_off``):
    card against CPU, CPU against float64, card against float64."""
    import dataclasses
    import torch
    cfg = configs.get_smoke_config("rwkv6-7b")
    gen = torch.Generator().manual_seed(3)
    on_cpu = Model(cfg, device="cpu", seed=0)
    with torch.no_grad():
        for name, p in on_cpu.named_parameters():
            if name.rsplit(".", 1)[-1].startswith("mu_"):
                p.uniform_(0.0, 1.0, generator=gen)
    ids = torch.randint(0, cfg.vocab_size, (2, 68), generator=gen)
    on_card = Model(cfg, device="cuda", seed=0)
    on_card.load_flat(on_cpu.flat.cuda())
    exact = Model(dataclasses.replace(cfg, param_dtype="float64",
                                      compute_dtype="float64"),
                  device="cuda", seed=0)
    exact.load_flat(on_cpu.flat.double().cuda())
    cpu = _serve_steps(on_cpu, ids, None, 64, 4, 68)
    card = _serve_steps(on_card, ids.cuda(), None, 64, 4, 68)
    with float64_everywhere():
        f64 = _serve_steps(exact, ids.cuda(), None, 64, 4, 68)
    return _steps_off(card, cpu), _steps_off(cpu, f64), _steps_off(card, f64)


def _full_logits(model, ids, vision, at=-1):
    """The full forward's float32 logits at position ``at`` (the last by
    default), or with a list of positions, the list of theirs."""
    import torch
    from repro_torch.models.layers import lm_head_logits
    with torch.inference_mode():
        x, _ = model.forward(ids, vision)
        w = model.lm_head.to(model.compute_dtype)
        logits = [lm_head_logits(w, x[:, t], model.ctx, model.cfg.vocab_size)
                  for t in ([at] if isinstance(at, int) else at)]
        return logits[0] if isinstance(at, int) else logits


def serve_consistency(model, ids, vision, prompt, steps, every=True,
                      round_to=None):
    """The model's prefill of ``ids[:, :prompt]`` and ``steps``
    teacher-forced decode steps against its full forward's last-position
    logits, after every step (``every``) or after the last only: the
    largest error over the largest logit, and whether each step is within
    the reference's own test's allclose (rtol 4e-3, atol 4e-3).  With
    ``round_to`` (a control) every cache leaf is rounded to that dtype in
    place after the prefill and after each step, as if the caches were
    held in it."""
    import torch

    def held(caches):       # the caches are inference tensors
        if round_to is not None:
            with torch.inference_mode():
                for c in caches:
                    for t in c:
                        t.copy_(t.to(round_to))

    n = prompt + steps
    logits, caches = model.prefill(ids[:, :prompt], vision, max_len=n,
                                   cache_shards=_shards(model))
    held(caches)
    worst, inside = 0.0, True
    for t in range(prompt, n):
        pos = torch.full((ids.shape[0],), t, dtype=torch.int32,
                         device=ids.device)
        logits, caches = model.decode(ids[:, t], pos, caches, vision)
        held(caches)
        if every or t == n - 1:
            want = _full_logits(model, ids[:, :t + 1], vision)
            worst = max(worst, _max_rel(logits, want))
            inside &= bool(((logits - want).abs()
                            <= 4e-3 + 4e-3 * want.abs()).all())
    return worst, inside


def serve_check(configs, Model, cuda):
    """Each of the 11 SMOKE configs (float32) with ``trained_like``
    weights and, for the VLM, 2 x 16 image embeddings: a prefill of 2 x
    128 tokens (a multiple of RWKV6's chunk of 32 and Mamba's of 64) and 8
    teacher-forced decode steps, max_len 136, on the card and on the CPU
    with the same weights: logits and every cache leaf within 1e-5 of
    their largest entry (5e-5 for jamba, as its gradient band); the same
    run again on the card, bit-equal; then the card's prefill of 64 and 64
    decode steps against its own full forward at 128 tokens (every step
    where the config has no recurrent mixer, the last where it does: RWKV6
    and Mamba take whole chunks), within 1e-4 of the largest logit and
    the reference's own test's allclose, with the MoE configs' capacity
    factor raised to num_experts so that nothing drops (prefill and the
    full forward route different token counts; card against CPU keeps the
    config's own factor).  Then rwkv6's SMOKE config at the init's decays
    (``init_decays_against_float64``), where float32's
    own rounding is larger: card and CPU each against float64 on the
    card, within 5e-5 (they read 1.1e-5 and 1.75e-5 of the largest
    logit), printed beside the card against the CPU.  Then
    ``python -m repro_torch.launch.serve`` (its ``main``) once on the
    card.  Serving computes no gradient, so
    none of the four kernels launches."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.launch import serve
    toks = np.random.default_rng(18).integers(0, 509, (2, 136))
    cuda.reset_launches()
    for arch in ["paper-proxy"] + configs.ARCH_NAMES:
        cfg = configs.get_smoke_config(arch)
        band = 5e-5 if arch == JAMBA else 1e-5
        ids = torch.from_numpy(toks % cfg.vocab_size)
        gen = torch.Generator().manual_seed(18)
        on_cpu = Model(cfg, device="cpu", seed=0)
        trained_like(on_cpu, gen)
        vision = (torch.randn(2, cfg.num_image_tokens, cfg.d_model,
                              generator=gen)
                  if cfg.cross_attn_every else None)
        on_card = Model(cfg, device="cuda", seed=0)
        on_card.load_flat(on_cpu.flat.cuda())
        vcard = None if vision is None else vision.cuda()
        runs = [_serve_steps(on_cpu, ids, vision, 128, 8, 136)]
        runs += [_serve_steps(on_card, ids.cuda(), vcard, 128, 8, 136)
                 for _ in range(2)]
        lerr, cerr = _steps_off(runs[1], runs[0])
        for (lg, cg), (lg2, cg2) in zip(runs[1], runs[2]):
            check(torch.equal(lg, lg2) and all(
                torch.equal(a, b) for x, y in zip(cg, cg2)
                for a, b in zip(x, y)), f"serve check {arch}: two runs on "
                "the card differ")
        check(lerr <= band and cerr <= band, f"serve check {arch}: logits "
              f"{lerr:.3g}, caches {cerr:.3g} of their largest entry off "
              f"the CPU's (band {band})")
        wide = (dataclasses.replace(cfg, capacity_factor=float(
            cfg.num_experts)) if cfg.moe else cfg)
        own = Model(wide, device="cuda", seed=0)
        own.load_flat(on_card.flat)
        recurrent = any(cfg.slot_kind(s) != "attn"
                        for s in range(cfg.group_size))
        cons, inside = serve_consistency(own, ids[:, :128].cuda(), vcard,
                                         64, 64, every=not recurrent)
        check(cons <= 1e-4 and inside, f"serve check {arch}: prefill + "
              f"decode {cons:.3g} of the largest logit off the full forward")
        factor = (f" (capacity factor {wide.capacity_factor})" if cfg.moe
                  else "")
        print(f"serve check {arch}: {cfg.name}, card against CPU: logits "
              f"{lerr:.2g}, caches {cerr:.2g} of their largest entry "
              f"(band {band}) over the prefill of 2 x 128 and 8 steps; two "
              f"runs bit-equal; 64 steps against the full forward at 128"
              f"{factor}: {cons:.2g}", flush=True)
        del on_cpu, on_card, own, runs
    (lx, cx), (l32, c32), (lg, cg) = init_decays_against_float64(configs,
                                                                 Model)
    check(max(l32, c32, lg, cg) <= 5e-5, f"serve check rwkv6-7b at the "
          f"init's decays: float32 off float64 by {max(l32, c32, lg, cg)}")
    print(f"serve check rwkv6-7b at the init's decays (2 x 64 prompt + 4 "
          f"steps; logits, caches): card against CPU {lx:.3g}, {cx:.3g}; "
          f"against float64 on the card: CPU {l32:.3g}, {c32:.3g}, card "
          f"{lg:.3g}, {cg:.3g}", flush=True)
    res = serve.run(serve.parse_args([]))
    check(res["tokens"].shape == (4, 16), f"serve launcher: tokens "
          f"{tuple(res['tokens'].shape)}")
    counts = dict(cuda.LAUNCHES)
    check(not any(counts.values()), f"serving launched kernels: {counts}")
    print(f"serve launcher: {res['config'].name}, 4 x 32 prompt, 16 "
          f"tokens, prefill {res['prefill_ms']:.1f} ms, decode "
          f"{res['decode_ms'] / 15:.2f} ms a step; launches of the three "
          f"kernels over the serve check: {counts}", flush=True)
    torch.cuda.empty_cache()


def serve_phase(configs, Model, cuda, name, arch, batch, prompt, gen,
                d, check_prompt, check_steps, every, band):
    """One whole model at full width through ``make_prefill_step`` and
    ``make_decode_step`` (float32 parameters, bf16 compute, weights from
    seed 0 and ``trained_like``): a ``batch`` x ``prompt`` prefill (once
    to warm up, then timed), then ``gen`` greedy tokens (``gen`` - 1
    decode steps, each synchronised), max_len ``prompt`` + ``gen``;
    prefill ms, decode ms a step (median and spread of the steps after
    the first), tokens/s, peak memory and the caches' bytes; a
    ``profile_step`` of one decode step; then, rebuilt at float32 compute
    with the same weights, the prefill of ``check_prompt`` tokens and
    ``check_steps`` teacher-forced steps of 2 rows against the full
    forward (``serve_consistency``): within ``band`` of the largest logit
    (set from the readings of earlier runs, far inside the reference's
    4e-3) and the reference's allclose, while a control whose caches are
    held at bfloat16 precision must read outside ``band``, so that the
    band tells a lower-precision cache apart."""
    import dataclasses
    import statistics
    import torch
    from repro_torch.serve import (ServeConfig, make_decode_step,
                                   make_prefill_step)
    cfg = configs.get_config(arch)
    torch.cuda.empty_cache()
    # what the card held before the phase: its peak counts the rest
    PEAK_BASE[name] = torch.cuda.memory_allocated()
    cuda.reset_launches()
    model = Model(cfg, device="cuda", seed=0)
    check(model.d == d, f"phase {name} d = {model.d}, expected {d}")
    trained_like(model, torch.Generator(device="cuda").manual_seed(19))
    g = torch.Generator(device="cuda").manual_seed(20)
    ids = torch.randint(0, cfg.vocab_size, (batch, prompt + check_steps),
                        generator=g, device="cuda")
    scfg = ServeConfig(max_len=prompt + gen)
    prefill = make_prefill_step(model, scfg)
    decode = make_decode_step(model, scfg)
    prefill(ids[:, :prompt])                  # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tok, caches = prefill(ids[:, :prompt])
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    cache_bytes = sum(t.nbytes for c in caches for t in c)
    step_ms, out = [], [tok]
    for i in range(gen - 1):
        pos = torch.full((batch,), prompt + i, dtype=torch.int32,
                         device="cuda")
        t0 = time.perf_counter()
        tok, caches = decode(tok, pos, caches)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        out.append(tok)
    peak = torch.cuda.max_memory_allocated()
    tokens = torch.stack(out, dim=1)
    check(tokens.shape == (batch, gen) and bool((tokens >= 0).all())
          and bool((tokens < cfg.vocab_size).all()),
          f"phase {name}: tokens {tuple(tokens.shape)}")
    steady = step_ms[1:]
    med = statistics.median(steady)
    spread = max(steady) - min(steady)
    tps = batch * (gen - 1) / (sum(step_ms) / 1e3)
    last = torch.full((batch,), prompt + gen - 1, dtype=torch.int32,
                      device="cuda")

    def step():
        decode(tok, last, caches)
        torch.cuda.synchronize()

    prof = profile_step(step, f"decode step of phase {name}, {arch}, batch "
                        f"{batch}")
    counts = dict(cuda.LAUNCHES)
    check(not any(counts.values()), f"phase {name}: kernels launched "
          f"{counts}")
    print(f"phase {name}: {arch} whole ({cfg.num_layers} layers, d = "
          f"{model.d}, bf16 compute), {batch} x {prompt} prompt: prefill "
          f"{prefill_ms:.1f} ms; {gen - 1} decode steps: first "
          f"{step_ms[0]:.2f} ms, then median {med:.2f} ms (spread "
          f"{spread:.2f}) a step, {tps:.1f} tokens/s; peak memory "
          f"{peak / 2**30:.2f} GiB, caches {cache_bytes / 2**20:.1f} MiB; "
          f"launches {counts}", flush=True)
    del model, caches, prefill, decode, step
    torch.cuda.empty_cache()
    exact = Model(dataclasses.replace(cfg, compute_dtype="float32"),
                  device="cuda", seed=0)
    trained_like(exact, torch.Generator(device="cuda").manual_seed(19))
    rows = ids[:2, prompt - check_prompt:]
    cons, inside = serve_consistency(exact, rows, None, check_prompt,
                                     check_steps, every)
    check(inside and cons <= band, f"phase {name}: float32 prefill + "
          f"decode off the full forward by {cons:.3g} of the largest logit "
          f"(band {band}; within the reference's allclose: {inside})")
    ctrl, _ = serve_consistency(exact, rows, None, check_prompt, check_steps,
                                every, round_to=torch.bfloat16)
    check(ctrl > band, f"phase {name}: the control with bfloat16 caches "
          f"reads {ctrl:.3g}, inside the band {band}")
    print(f"phase {name}: float32 compute, 2 x {check_prompt} prompt + "
          f"{check_steps} decode steps against the full forward: "
          f"{cons:.3g} of the largest logit (band {band}; the reference's "
          f"4e-3); the control with caches held in bfloat16: {ctrl:.3g}",
          flush=True)
    del exact
    torch.cuda.empty_cache()
    return {"card_arch": arch, "d": d, "batch": batch, "prompt": prompt,
            "gen": gen, "prefill_ms": prefill_ms, "step_ms": step_ms,
            "median_ms": med, "spread_ms": spread, "tokens_per_s": tps,
            "peak_bytes": peak, "cache_bytes": cache_bytes,
            "profile": prof, "consistency": cons, "control": ctrl}


def resume_check(train):
    """paper-proxy, two_phase + ef through the launcher: 8 steps straight
    against 4 steps and a resumed launch to 8."""
    import shutil
    ck = os.path.join(ROOT, "build", "chip_smoke_resume")
    shutil.rmtree(ck, ignore_errors=True)
    argv = ["--arch", "paper-proxy", "--workers", "4", "--sync", "two_phase",
            "--compress", "ef", "--bits", "3", "--bucket", "1024",
            "--update-at", "2", "--lr", "2e-3"]
    straight = train.run(train.parse_args(argv + ["--steps", "8"]))
    first = train.run(train.parse_args(argv + ["--steps", "4", "--ckpt-dir",
                                               ck]))
    second = train.run(train.parse_args(argv + ["--steps", "8", "--ckpt-dir",
                                                ck]))
    shutil.rmtree(ck, ignore_errors=True)
    want = [h["loss"] for h in straight["history"]]
    got = [h["loss"] for h in first["history"] + second["history"]]
    check([h["step"] for h in second["history"]] == [4, 5, 6, 7],
          "resume did not start after the saved step")
    a = straight["trainer"].model.flat
    b = second["trainer"].model.flat
    same = got == want and bool((a == b).all())
    diff = float((a - b).abs().max())
    loss_diff = max(abs(x - y) for x, y in zip(got, want))
    if not same:
        check(bool(((a - b).abs() <= 1e-6 * a.abs()).all())
              and loss_diff <= 1e-6 * max(map(abs, want)),
              f"resumed run beyond rtol 1e-6: params {diff}, loss "
              f"{loss_diff}")
    print(f"resume check: losses {'equal' if got == want else 'differ'} "
          f"(max diff {loss_diff:.3g}), final parameters "
          f"{'equal' if bool((a == b).all()) else 'differ'} (max diff "
          f"{diff:.3g}) over 8 steps, resumed at step 4", flush=True)


def micro_check(train):
    """paper-proxy, 4 workers: two micro-batches a worker against one.
    The gradient sums are taken in another order, and a moved tie can
    change a code, so the losses are held at rtol 1e-4."""
    argv = ["--arch", "paper-proxy", "--workers", "4", "--bits", "3",
            "--bucket", "1024", "--update-at", "2", "--lr", "2e-3",
            "--steps", "4"]
    one = [h["loss"] for h in train.run(train.parse_args(argv))["history"]]
    two = [h["loss"] for h in train.run(train.parse_args(
        argv + ["--micro", "2"]))["history"]]
    rel = max(abs(a - b) / abs(a) for a, b in zip(one, two))
    check(rel <= 1e-4, f"--micro 2 losses {two} against {one}")
    print(f"micro check: --micro 2 against --micro 1 over 4 steps, losses "
          f"within rtol {rel:.3g}: {two}", flush=True)


def rank_run(argv: list[str]) -> None:
    """Phase M's and P1's child (``chip_smoke.py --rank-run OUT
    [--deterministic] ARGV... [--then ARGV...]...``, under torchrun or
    alone): one launcher run for each ARGV in turn, in this process, each
    with every launch count set to 0 just before it (an ARGV of
    ``--serve-grid`` is phase Q2, ``serve_grid``); writes each run's
    losses, step and stage times, the sha256 of its final parameters, its
    launches and its peak memory to OUT/rank<R>.json (R the group rank,
    or "stacked"): the run's record, or with several runs {"rank": R,
    "runs": [record, ...]} (several runs share the process's start-up and
    first grad, which costs 9-16 s a process)."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import cuda
    from repro_torch.launch import train
    out, argv = argv[0], argv[1:]
    if argv[:1] == ["--deterministic"]:
        torch.use_deterministic_algorithms(True)
        argv = argv[1:]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda.build()
    prints = []
    if "--tp" in argv:      # phase P1: each step's parameters, fingerprinted
        from repro_torch.train.train_step import Trainer
        step = Trainer.train_step

        def fingerprinted(self, *args, **kwargs):
            m = step(self, *args, **kwargs)
            prints.append(fingerprint(self.model.flat))
            return m
        Trainer.train_step = fingerprinted
    runs = [[]]
    for a in argv:
        if a == "--then":
            runs.append([])
        else:
            runs[-1].append(a)
    recs = []
    try:
        for one in runs:
            torch.cuda.reset_peak_memory_stats()
            cuda.reset_launches()
            if one == ["--serve-grid"]:     # phase Q2, in P1's ranks
                recs.append(serve_grid())
                continue
            res = train.run(train.parse_args(one))
            counts, layouts = dict(cuda.LAUNCHES), dict(cuda.LAYOUTS)
            peak = torch.cuda.max_memory_allocated()
            recs.append({
                "rank": dist.get_rank() if dist.is_initialized()
                else "stacked", "d": res["d"],
                "layers": res["config"].num_layers,
                "device": str(res["trainer"].model.flat.device),
                "loss": [h["loss"] for h in res["history"]],
                "step_ms": [h["step_ms"] for h in res["history"]],
                "stage_ms": [h["stage_ms"] for h in res["history"]],
                "corrupt": [h["corrupt_fraction"] for h in res["history"]],
                "digest": train.params_digest(res["trainer"].model.flat),
                "launches": counts, "layouts": layouts, "peak_bytes": peak,
                "model_rank": res["trainer"].model.ctx.rank,
                "fingerprints": prints,
                "tp": [h.get("tp_all_reduce") for h in res["history"]]})
            del res
            torch.cuda.empty_cache()
        rank = recs[0]["rank"]
        rec = recs[0] if len(recs) == 1 else {"rank": rank, "runs": recs}
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def fingerprint(flat) -> list[int]:
    """Three int64 sums of the flat's 32-bit words on the card (plain,
    weighted by the position in a row of 4096, and the row sums weighted
    by the row): equal flats give equal sums, and two flats that differ
    almost surely do not; a few ms, against seconds for a sha256 on the
    host."""
    import torch
    w = flat.detach().reshape(-1).view(torch.int32)
    c = 4096
    pos = torch.arange(1, c + 1, device=w.device, dtype=torch.int64)
    a = b = r = 0
    rows = 0
    step = c * 16384
    for lo in range(0, w.numel(), step):
        part = w[lo:lo + step].to(torch.int64)
        part = torch.nn.functional.pad(part, (0, -part.numel() % c))
        part = part.view(-1, c)
        rs = part.sum(1)
        ridx = torch.arange(rows + 1, rows + 1 + rs.numel(),
                            device=w.device, dtype=torch.int64)
        a += int(rs.sum())
        b += int((part * pos).sum())
        r += int((rs * ridx).sum())
        rows += rs.numel()
    return [a, b, r]


def _steady(rec: dict, update_at: int) -> tuple[float, float, int]:
    """Median and spread of the step times after the first that are not
    level-update steps, and how many there are."""
    import statistics
    ms = [t for i, t in enumerate(rec["step_ms"]) if i and i != update_at]
    return statistics.median(ms), max(ms) - min(ms), len(ms)


def _stacked(argv: list[str], ranks: int) -> list[str]:
    return argv + ["--device", "cuda:0", "--workers", str(ranks)]


def _group(argv: list[str], backend: str) -> list[str]:
    return argv + ["--device", "cuda:0", "--backend", backend]


def _runs(phase: str, label: str, argvs: list[list[str]], nproc: int
          ) -> list[list]:
    """``--rank-run`` of several runs in one child (``nproc`` processes
    under torchrun, 0: one plain process): for each run, every process's
    record, each with the process's ``wall_s``."""
    joined = []
    for argv in argvs:
        joined += (["--then"] if joined else []) + argv
    recs = _child_runs(phase, "--rank-run", label, joined, nproc)
    return [[dict(r["runs"][i], wall_s=r["wall_s"]) for r in recs]
            for i in range(len(argvs))]


def phase_m_run(name: str, argv: list[str], ranks: int, backend: str,
                kernels_needed, recs: list[dict], base: dict) -> dict:
    """One phase-M cell: ``recs``, the launcher's run in ``ranks``
    processes over ``backend`` on cuda:0, against ``base``, the stacked
    launcher's with ``--workers ranks`` (``phase_m`` runs the cells in
    shared processes); every step's loss and the final parameters'
    sha256 must agree bit for bit on every rank (else both run again,
    each in processes of their own, under deterministic algorithms, and
    must agree there)."""
    def agree():
        return all(r["loss"] == base["loss"] and r["digest"] == base["digest"]
                   for r in recs)

    deterministic = not agree()
    if deterministic:
        print(f"phase {name}: ranks {[r['loss'] for r in recs]} against "
              f"stacked {base['loss']}: not bit-equal; again under "
              "deterministic algorithms", flush=True)
        env = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
        recs = _child_runs("M", "--rank-run", f"{name}-group",
                           ["--deterministic"] + _group(argv, backend), ranks,
                           env)
        base = _child_runs("M", "--rank-run", f"{name}-stacked",
                           ["--deterministic"] + _stacked(argv, ranks), 0,
                           env)[0]
    same = agree()
    check(same, f"phase {name}: ranks and stacked differ under "
          f"deterministic algorithms: {[r['loss'] for r in recs]} against "
          f"{base['loss']}")
    check(all(r["rank"] == i for i, r in enumerate(recs)),
          f"phase {name} ranks {[r['rank'] for r in recs]}")
    for r in recs + [base]:
        check(all(math.isfinite(x) for x in r["loss"]),
              f"phase {name} loss not finite: {r['loss']}")
        check(r["device"] == "cuda:0", f"phase {name} on {r['device']}")
    for r in recs:
        check(all(r["launches"].get(k, 0) > 0 for k in kernels_needed),
              f"phase {name} rank {r['rank']} kernel launches "
              f"{r['launches']}")
    update_at = int(argv[argv.index("--update-at") + 1])
    for r in recs + [base]:
        med, spread, n = _steady(r, update_at)
        split = "; ".join(", ".join(f"{k} {v:.1f}" for k, v in st.items())
                          for st in r["stage_ms"])
        who = f"stacked x{ranks}" if r is base else f"rank {r['rank']}"
        print(f"phase {name} {who}: d={r['d']}, {r['layers']} layers, "
              f"steady step {med:.1f} ms (spread {spread:.1f}, {n} steps), "
              f"steps ms "
              f"{[round(t, 1) for t in r['step_ms']]}, stages ms by step "
              f"[{split}], peak memory {r['peak_bytes'] / 2**30:.2f} GiB, "
              f"launches {r['launches']}, process {r['wall_s']:.1f} s",
              flush=True)
    how = " under deterministic algorithms" if deterministic else ""
    print(f"phase {name}: {ranks} {backend} ranks and the stacked "
          f"--workers {ranks} run bit-equal{how}: losses {base['loss']}, "
          f"sha256 {base['digest'][:16]}...", flush=True)
    return {"ranks": recs, "stacked": base, "backend": backend,
            "deterministic_rerun": deterministic}


def phase_m(smi: str) -> dict:
    """Phase M: data parallelism across processes, each run in
    subprocesses while this process holds no large tensor on the card.
    M1: qwen3-0.6b at full width cut to ``M1_LAYERS`` of its 28 layers,
    2 gloo ranks on cuda:0 (phase H's setting at M = 2); M2: its first 4
    layers, two_phase + ef + integrity, 5 steps; M3: NCCL at world size
    1, qwen3-0.6b's SMOKE config.  The three stacked runs they are held
    against share one process, and M1's and M2's gloo ranks share a
    pair of processes (a child's start-up and first grad cost 9-16 s)."""
    import torch
    torch.cuda.empty_cache()
    print(f"phase M: this process holds "
          f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB on the card",
          flush=True)
    full = ["--arch", "qwen3-0.6b", "--batch", "4", "--seq", "1024",
            "--data", "uniform", "--scheme", "alq", "--bits", "3",
            "--bucket", str(BS_B), "--optim", "adamw", "--lr", "1e-4",
            "--update-at", "1", "--time-stages"]
    kernels = ("quantize", "dequantize", "dequantize_mean", "bucket_stats")
    cells = {"M1": (full + ["--layers", str(M1_LAYERS), "--steps", "3"], 2,
                    "gloo"),
             "M2": (full + ["--layers", "4", "--steps", "5", "--sync",
                            "two_phase", "--compress", "ef", "--integrity"],
                    2, "gloo"),
             "M3": (["--arch", "qwen3-0.6b", "--smoke", "--batch", "2",
                     "--seq", "1024", "--data", "uniform", "--update-at",
                     "1", "--time-stages", "--steps", "3"], 1, "nccl")}
    stacked = _runs("M", "stacked", [_stacked(a, n) for a, n, _ in
                                     cells.values()], 0)
    gloo = _runs("M", "M12-group", [_group(cells[k][0], "gloo")
                                    for k in ("M1", "M2")], 2)
    nccl = _child_runs("M", "--rank-run", "M3-group",
                       _group(cells["M3"][0], "nccl"), 1)
    out = {"card": smi}
    for (name, (argv, ranks, backend)), recs, base in zip(
            cells.items(), gloo + [nccl], stacked):
        out[name] = phase_m_run(name, argv, ranks, backend, kernels, recs,
                                base[0])
    check(out["M1"]["stacked"]["d"] == D_M1
          and out["M1"]["stacked"]["layers"] == M1_LAYERS,
          f"phase M1 is not qwen3-0.6b at {M1_LAYERS} layers")
    check(all(c == 0.0 for r in out["M2"]["ranks"] for c in r["corrupt"]),
          "phase M2 corrupt buckets on a clean wire")
    return out


def phase_n(configs, Model, layers, smi: str) -> dict:
    """Phase N: rematerialization and the chunked loss at full width.
    llama3.2-1b whole (16 layers, d = 1,498,482,688, V = 128,256), one
    worker's forward and backward at train_4k's 4096 tokens a row.  At
    one row (two rows under "none" exceed the card: the blockwise
    attention keeps a float32 tile a head and block pair): ``remat``
    "none" (twice: the spread of two identical passes), "dots" and
    "full" with the chunked loss, and "full" with the whole-sequence
    loss (one (B, 4096, V) float32 logits tensor); at two rows "full"
    with the chunked and with the whole-sequence loss.  Each pass's ms
    and peak memory (absolute, and added over the model and its gradient
    row), each the second pass of its setting.  At one row the gradients
    of "dots" and "full" must equal
    "none"'s bit for bit where two "none" passes do, else within their
    spread; the whole-sequence loss's within 2^-6 of the largest entry
    (the chunked loss adds its chunks' bfloat16 LM-head gradients in
    bfloat16: a few ulps)."""
    import torch
    torch.cuda.empty_cache()
    cfg = configs.get_config("llama3.2-1b")
    check(cfg.num_layers == 16 and cfg.vocab_size == 128_256,
          "phase N is not llama3.2-1b whole")
    model = Model(cfg, device="cuda", seed=0, remat="none")
    grad = torch.zeros_like(model.flat)
    model.attach_grads(grad)
    g = torch.Generator(device="cuda").manual_seed(21)
    S = 4096
    ids = torch.randint(0, cfg.vocab_size, (2, S + 1), generator=g,
                        device="cuda")
    cd = model.compute_dtype

    def one(remat, rows, whole=False, keep=True):
        model.remat = remat
        grad.zero_()
        x_ids, labels = ids[:rows, :-1], ids[:rows, 1:]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if whole:
            x, aux = model.forward(x_ids)
            loss = layers.lm_head_loss(model.lm_head.to(cd), x, labels,
                                       chunk=S) + aux / cfg.num_layers
            del x
        else:
            loss = model.loss(x_ids, labels)
        loss.backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        return {"rows": rows, "ms": ms, "peak_bytes": peak,
                "added_bytes": peak - base, "loss": loss.item()}, \
            grad.to("cpu", copy=True) if keep else None

    runs = {}
    ref_grad = spread = scale = None
    for name, remat, rows, whole in (
            ("none", "none", 1, False), ("none_again", "none", 1, False),
            ("dots", "dots", 1, False), ("full", "full", 1, False),
            ("full_whole_loss", "full", 1, True),
            ("full_2_rows", "full", 2, False),
            ("full_whole_loss_2_rows", "full", 2, True)):
        if name != "none_again":
            one(remat, rows, whole, keep=False)   # warm-up of the setting
        r, got = one(remat, rows, whole)
        runs[name] = r
        check(math.isfinite(r["loss"]) and bool(torch.isfinite(got).all()),
              f"phase N {name}: not finite")
        if rows == 2:
            del got
            continue
        if ref_grad is None:
            ref_grad, scale = got, float(got.abs().max())
            continue
        diff = float((got - ref_grad).abs().max())
        r["max_abs_diff"] = diff
        if name == "none_again":
            spread = diff
            runs["none"]["spread"] = spread
        elif name == "full_whole_loss":
            # the chunks' bf16 LM-head gradients add up in bf16 (as the
            # reference's scan adds them): a few bf16 ulps of the largest
            check(diff <= 2**-6 * scale, f"phase N whole-sequence loss: "
                  f"gradient {diff} off, beyond 2^-6 of {scale}")
        elif spread == 0.0:
            check(torch.equal(got, ref_grad)
                  and r["loss"] == runs["none"]["loss"],
                  f"phase N {name}: gradient not bit-equal to none's "
                  f"(max diff {diff})")
        else:
            check(diff <= spread, f"phase N {name}: {diff} beyond two none "
                  f"passes' spread {spread}")
        del got
    base_gib = (model.flat.numel() * 8) / 2**30
    for name, r in runs.items():
        print(f"phase N {name} ({r['rows']} x {S}): grad {r['ms']:.1f} ms, "
              f"peak {r['peak_bytes'] / 2**30:.2f} GiB "
              f"(+{r['added_bytes'] / 2**30:.2f} over parameters and "
              f"gradient row, {base_gib:.2f} GiB), loss {r['loss']:.6f}"
              + (f", max |g - g_none| {r['max_abs_diff']:.3g}"
                 if "max_abs_diff" in r else ""), flush=True)
    same = "bit-equal" if spread == 0.0 else f"within the spread {spread:.3g}"
    print(f"phase N: llama3.2-1b whole, 1 x {S} tokens: two none passes "
          f"differ by {spread:.3g}; dots and full {same} to none; "
          f"largest gradient entry {scale:.4g}", flush=True)
    del model, grad, ref_grad
    torch.cuda.empty_cache()
    return {"card": smi, "d": D_K, "runs": runs}


def fsdp_run(argv: list[str]) -> None:
    """Phase O's child (``chip_smoke.py --fsdp-run OUT MODE...``, under
    torchrun or alone): for each MODE in turn, in this one process,
    qwen3-0.6b whole, M = 2 workers (2 x 1024 uniform tokens a worker),
    ALQ 3-bit, buckets of 8192, AdamW lr 1e-4, a level update at step 1,
    3 steps, through ``Model``/``Trainer`` with every launch count set to
    0 just before.  MODE: ``quantized`` (FSDP, the quantized
    reduce-scatter), ``fp32`` (FSDP, the float32 mean) or ``dp`` (the DP
    model, ``sync_mode="fp32"``).  Writes each mode's losses, step and
    stage times, each local worker's shard digest (FSDP) or the
    parameters' digest (DP), launches and peak memory to
    OUT/rank<R>.json (a record of each mode under ``runs``, or the one
    mode's record), and the first step's first moment (in the DP layout,
    for fp32 and dp) to OUT/mu0-<MODE>.pt."""
    import hashlib
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.core.schemes import QuantScheme
    from repro_torch.kernels import cuda
    from repro_torch.launch import mesh
    from repro_torch.models.transformer import Model
    from repro_torch.timing import StageClock
    from repro_torch.train.data import DataConfig, Pipeline
    from repro_torch.train.optim import OptimConfig
    from repro_torch.train.train_step import TrainConfig, Trainer
    from repro_torch import weights
    out, *modes = argv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda.build()
    transport = None
    if mesh.world_size():
        _, transport = mesh.init_process_group("gloo", "cuda:0")
    rank = transport.rank() if transport is not None else "stacked"
    dev = torch.device("cuda:0")
    M = 2
    cfg = configs.get_config("qwen3-0.6b")
    scheme = QuantScheme(name="alq", bits=3, bucket_size=BS_B)
    runs = {}
    try:
        for mode in modes:
            if mode == "dp":
                model = Model(cfg, device=dev, seed=0)
            else:
                model = Model(cfg, device=dev, seed=0, param_mode="fsdp",
                              dp=M, transport=transport, fsdp_scheme=scheme,
                              fsdp_sync=mode)
            tcfg = TrainConfig(
                scheme=scheme, optim=OptimConfig(name="adamw", lr=1e-4,
                                                 weight_decay=0.0),
                sync_mode="fp32" if mode == "dp" else "all_gather",
                update_milestones=(1,), update_every=0, workers=M)
            trainer = Trainer(model, tcfg, seed=0, transport=transport)
            pipe = Pipeline(DataConfig(kind="uniform",
                                       vocab_size=cfg.vocab_size,
                                       seq_len=1024, global_batch=2 * M,
                                       seed=0))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cuda.reset_launches()
            rec = {"mode": mode, "rank": rank, "loss": [], "step_ms": [],
                   "stage_ms": []}
            for t in range(3):
                batch = pipe.batch(t, dev)
                clock = StageClock(dev)
                t0 = time.perf_counter()
                m = trainer.train_step(batch, clock=clock)
                rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
                rec["stage_ms"].append(clock.stage_ms())
                rec["loss"].append(m["loss"])
                if t == 0 and mode != "quantized":
                    mu = trainer.opt.mu
                    if mode == "fp32":
                        mu = weights.fsdp_to_dp(model.global_flat(mu), cfg,
                                                BS_B, M)
                    if transport is None or transport.rank() == 0:
                        torch.save(mu.cpu(),
                                   os.path.join(out, f"mu0-{mode}.pt"))
                    del mu
            rec["launches"] = dict(cuda.LAUNCHES)
            rec["layouts"] = dict(cuda.LAYOUTS)
            rec["peak_bytes"] = torch.cuda.max_memory_allocated()
            rec["d"] = model.d
            flat = model.flat.detach()
            workers = (model.local if mode != "dp" else [0])
            rec["digests"] = {str(w): hashlib.sha256(
                (model.local_rows(model.global_flat(flat), [w])
                 if mode != "dp" and transport is None else flat
                 ).cpu().view(torch.uint8).numpy()).hexdigest()
                for w in workers}
            runs[mode] = rec
            del model, trainer, flat
            torch.cuda.empty_cache()
        rec = runs[modes[0]] if len(modes) == 1 else {"rank": rank,
                                                      "runs": runs}
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _child_runs(phase: str, flag: str, label: str, args: list[str],
                nproc: int, env: dict | None = None) -> list[dict]:
    """``chip_smoke.py FLAG OUT ARGS...`` in ``nproc`` processes under
    torchrun (0: one plain process), OUT = build/phase_<phase>/LABEL,
    with ``env`` added to the environment; every process's record (its
    rank<R>.json)."""
    import glob
    import shutil
    out = os.path.join(ROOT, "build", f"phase_{phase.lower()}", label)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    cmd = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", str(nproc)] if nproc else [sys.executable])
    env = dict(os.environ, OMP_NUM_THREADS="1", **(env or {}))
    t0 = time.perf_counter()
    sub = subprocess.run(cmd + [os.path.abspath(__file__), flag, out, *args],
                         env=env, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    check(sub.returncode == 0, f"phase {phase} {label} failed (rc "
          f"{sub.returncode}): {sub.stdout[-2000:]}\n{sub.stderr[-4000:]}")
    recs = [json.load(open(f)) for f in sorted(glob.glob(
        os.path.join(out, "rank*.json")))]
    check(len(recs) == max(nproc, 1), f"phase {phase} {label}: "
          f"{len(recs)} records")
    for r in recs:
        r["wall_s"] = wall
        r["dir"] = out
    return recs


def phase_o(smi: str) -> dict:
    """Phase O: FSDP, each run a subprocess while this process holds no
    large tensor on the card.  O1: qwen3-0.6b whole in 2 gloo ranks on
    cuda:0, the quantized reduce-scatter, against the stacked M = 2 FSDP
    run: every rank's losses and shard digest bit-equal; every rank
    launches the three kernels FSDP runs (no dequantize_mean).  O2: the
    float32 FSDP run against the DP run (``sync_mode="fp32"``), one after
    the other in the process of the stacked O1 run: losses rtol 1e-5,
    the first step's first moment (0.1 x the aggregate) within 1e-6 of its
    largest entry."""
    import statistics
    import torch
    torch.cuda.empty_cache()
    out = {"card": smi}
    ranks = _child_runs("O", "--fsdp-run", "O1-group", ["quantized"], 2)
    # the stacked quantized run and O2's two share one process
    o2 = _child_runs("O", "--fsdp-run", "stacked",
                     ["quantized", "fp32", "dp"], 0)[0]
    stacked, fp32, dp = (dict(o2["runs"][k], wall_s=o2["wall_s"])
                         for k in ("quantized", "fp32", "dp"))
    for r in ranks:
        check(r["loss"] == stacked["loss"], f"phase O rank {r['rank']} "
              f"losses {r['loss']} against stacked {stacked['loss']}")
        for w, dg in r["digests"].items():
            check(dg == stacked["digests"][w], f"phase O rank {r['rank']} "
                  f"shard {w} differs from the stacked run's")
        check(all(r["launches"].get(k, 0) > 0 for k in (
            "quantize", "dequantize", "bucket_stats")),
            f"phase O rank {r['rank']} launches {r['launches']}")
        check(all(math.isfinite(x) for x in r["loss"]), "phase O loss")
    rel = max(abs(a - b) / abs(b) for a, b in zip(fp32["loss"], dp["loss"]))
    check(rel <= 1e-5, f"phase O fp32 FSDP losses {fp32['loss']} against DP "
          f"{dp['loss']} (rel {rel})")
    mu_f = torch.load(os.path.join(o2["dir"], "mu0-fp32.pt"))
    mu_d = torch.load(os.path.join(o2["dir"], "mu0-dp.pt"))
    scale = float(mu_d.abs().max())
    diff = float((mu_f - mu_d).abs().max())
    check(diff <= 1e-6 * scale, f"phase O fp32 FSDP aggregate {diff} off "
          f"the DP mean's, beyond 1e-6 of {scale}")
    del mu_f, mu_d
    for r in ranks + [stacked, fp32, dp]:
        steady = r["step_ms"][2]
        split = "; ".join(", ".join(f"{k} {v:.1f}" for k, v in st.items())
                          for st in r["stage_ms"])
        who = (f"rank {r['rank']}" if r in ranks else
               {"quantized": "stacked x2", "fp32": "fp32 FSDP stacked x2",
                "dp": "DP fp32 stacked x2"}[r["mode"]])
        print(f"phase O {who}: steps ms {[round(t, 1) for t in r['step_ms']]}"
              f" (step 2: {steady:.1f}), stages ms by step [{split}], peak "
              f"memory {r['peak_bytes'] / 2**30:.2f} GiB, launches "
              f"{r['launches']}, process {r['wall_s']:.1f} s", flush=True)
    print(f"phase O: 2 gloo ranks and the stacked FSDP run bit-equal: "
          f"losses {stacked['loss']}; fp32 FSDP against DP: losses rel "
          f"{rel:.3g}, first moment max diff {diff:.3g} (largest "
          f"{scale:.4g})", flush=True)
    out.update(ranks=ranks, stacked=stacked, fp32=fp32, dp=dp,
               fp32_loss_rel=rel, fp32_mu_diff=diff, fp32_mu_scale=scale,
               median_step_ms=statistics.median(
                   [r["step_ms"][2] for r in ranks]))
    return out


def fsdp_shapes(ops, ref, lv, out):
    """Each FSDP round's kernels at phase O's shapes (qwen3-0.6b, M = 2,
    buckets of 8192: a layer slot's round encodes 240 buckets, embed's
    and lm_head's 2376; a round decodes as many, the M received streams
    of ppr buckets), against the plain versions, timed in 3 rounds."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)
    levels = lv.uniform_levels(3, device=dev)
    L = levels.numel()
    for nb, what in ((240, "a layer slot's round"),
                     (2376, "embed's or lm_head's round")):
        vb = torch.randn(nb, BS_B, generator=g, device=dev) * 1e-3
        u = torch.rand(nb, BS_B, generator=g, device=dev)
        codes, norms = ops.quantize_op(vb, u, levels)
        c2, n2 = ref.quantize_ref(vb, u, levels, "l2")
        check(bool(torch.allclose(norms, n2, rtol=1e-5, atol=0)),
              f"quantize norms at FSDP's {nb} buckets beyond rtol 1e-5")
        worst = float((norms - n2).abs().max())
        mism = ref.code_mismatches(codes, c2, vb, u, n2, levels)
        n = nb * BS_B
        record_shape(out, "phase O shape", "quantize",
                     f"({nb}, {BS_B}) f32 l2 3-bit",
                     lambda: ops.quantize_op(vb, u, levels),
                     lambda: ref.quantize_ref(vb, u, levels, "l2"),
                     n * 9 + nb * 4, n * (20 + math.log2(L)), worst,
                     f"FSDP encode of {what}, {mism} codes off by one at "
                     "ties")
        c32 = codes.to(torch.int32)
        got = ops.dequantize_op(c32, norms, levels)
        check(torch.equal(got, ref.dequantize_ref(c32, norms, levels)),
              f"dequantize at FSDP's {nb} buckets not exact")
        record_shape(out, "phase O shape", "dequantize",
                     f"({nb}, {BS_B}) int32",
                     lambda: ops.dequantize_op(c32, norms, levels),
                     lambda: ref.dequantize_ref(c32, norms, levels),
                     n * 8 + nb * 4, n * 5, 0.0,
                     f"FSDP decode of {what}'s 2 received streams")
        del vb, u, codes, norms, c2, n2, c32, got
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def split_tp1(flat1, cfg, tp: int, rank: int):
    """A dense config's tp = 1 flat -> model rank ``rank``'s flat at
    ``tp`` holding the same weights: the vocabulary of embed and lm_head,
    wq's and the FFN's columns and wo's and w2's rows cut in tp, the
    other leaves whole."""
    import torch
    from repro_torch.models.transformer import param_layout
    views, off = {}, 0
    for name, shape, _ in param_layout(cfg, 1):
        n = math.prod(shape)
        views[name] = flat1[off:off + n].view(shape)
        off += n
    parts = []
    for name, shape, _ in param_layout(cfg, tp):
        v = views[name]
        ax = {"embed": 1, "lm_head": 2}.get(name)
        if name.endswith((".wq", ".bq", ".w1", ".w3")):
            ax = v.dim() - 1
        elif name.endswith((".wo", ".w2")):
            ax = 2
        if ax is not None:
            v = torch.chunk(v, tp, dim=ax)[rank]
        check(tuple(v.shape) == tuple(shape), f"split {name} {v.shape}")
        parts.append(v.reshape(-1))
    return torch.cat(parts)


def _sharded(name: str) -> bool:
    return name in ("embed", "lm_head") or name.endswith(
        (".wq", ".bq", ".w1", ".w3", ".wo", ".w2"))


def tp_check(argv: list[str]) -> None:
    """Phase P's children (``chip_smoke.py --tp-check OUT MODE...``, under
    torchrun, 2 gloo ranks sharing cuda:0, one model group of 2; each
    MODE in turn).
    ``serve``, phase Q1: ``serve_tp``.
    ``f32``, P1f: qwen3-0.6b whole at float32 compute, one forward and
    backward of 2 x 1024 tokens at tp = 1 (seed 0) and at tp = 2 with the
    same weights cut in two (``split_tp1``): the losses, and every leaf's
    gradient against 2x the tp = 1 gradient (a sharded leaf's shard, a
    replicated leaf's sum over the two ranks).  ``p2``: each of
    ``P2_BANDS``'s SMOKE configs, one train step at tp = 2 (2 x 256
    tokens, ALQ 3-bit, buckets of 1024, a level update, one data worker)
    on the CPU and on the card from the same weights (``trained_like``)
    and uniforms: the losses and gradient rows, and the card's launches.
    Writes OUT/rank<R>.json."""
    import dataclasses
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.core.codec import codec_for_scheme
    from repro_torch.core.schemes import QuantScheme
    from repro_torch.kernels import cuda
    from repro_torch.launch import mesh
    from repro_torch.models.layers import TPStats
    from repro_torch.models.transformer import Model, param_layout
    from repro_torch.train.optim import OptimConfig
    from repro_torch.train.train_step import TrainConfig, Trainer
    out, *modes = argv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda.build()
    grid = mesh.init_grid(2, "gloo", "cuda:0")
    dev, ctx, rank = grid.device, grid.tp_ctx, dist.get_rank()
    rec = {"rank": rank, "modes": modes}

    def grad_of(model, ids, vision=None):
        row = torch.zeros_like(model.flat)
        model.attach_grads(row)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = model.loss(ids[:, :-1], ids[:, 1:], vision)
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), row, (time.perf_counter() - t0) * 1e3

    try:
        for mode in modes:
            if mode == "f32":
                cfg = dataclasses.replace(configs.get_config("qwen3-0.6b"),
                                          compute_dtype="float32")
                ids = torch.from_numpy(np.random.default_rng(15).integers(
                    0, cfg.vocab_size, (2, 1025))).to(dev)
                one = Model(cfg, device=dev, seed=0)
                l1, g1, ms1 = grad_of(one, ids)
                mine = split_tp1(one.flat, cfg, 2, ctx.rank)
                g1 = split_tp1(g1, cfg, 2, ctx.rank)
                del one
                torch.cuda.empty_cache()
                two = Model(cfg, device=dev, seed=0, tp_ctx=ctx)
                two.load_flat(mine)
                del mine
                torch.cuda.reset_peak_memory_stats()
                TPStats.reset()
                l2, g2, ms2 = grad_of(two, ids)
                rec.update(loss1=l1, loss2=l2, ms1=ms1, ms2=ms2,
                           tp_calls=TPStats.calls, tp_bytes=TPStats.bytes,
                           peak_bytes=torch.cuda.max_memory_allocated())
                worst = {"sharded": 0.0, "replicated": 0.0}
                off = 0
                for name, shape, _ in param_layout(cfg, 2):
                    n = math.prod(shape)
                    got, want = g2[off:off + n], 2 * g1[off:off + n]
                    kind = "sharded" if _sharded(name) else "replicated"
                    if kind == "replicated":
                        got = got.clone()
                        dist.all_reduce(got, group=ctx.process_group)
                    scale = float(want.abs().max())
                    if scale > 0:
                        err = float((got - want).abs().max()) / scale
                        worst[kind] = max(worst[kind], err)
                    off += n
                rec["worst"] = worst
                del two, g1, g2
                torch.cuda.empty_cache()
            elif mode == "serve":
                rec["serve"] = serve_tp(grid)
            else:
                scheme = QuantScheme(name="alq", bits=3, bucket_size=1024)
                rec["configs"] = {}
                for arch in P2_BANDS:
                    cfg = configs.get_smoke_config(arch)
                    on_cpu = Model(cfg, device="cpu", seed=0, tp_ctx=ctx)
                    gen = torch.Generator().manual_seed(14)
                    trained_like(on_cpu, gen)
                    ids = torch.from_numpy(np.random.default_rng(14).integers(
                        0, cfg.vocab_size, (2, 257)))
                    batch = {"ids": ids[:, :-1], "labels": ids[:, 1:]}
                    if cfg.cross_attn_every:
                        batch["vision"] = torch.randn(
                            2, cfg.num_image_tokens, cfg.d_model,
                            generator=gen)
                    plan = codec_for_scheme(scheme).plan(on_cpu.d)
                    u = torch.rand(plan.nb, plan.bucket_size, generator=gen)
                    flat0 = on_cpu.flat.clone()     # the step updates on_cpu
                    res = []
                    for d in ("cpu", dev):
                        model = on_cpu
                        if d != "cpu":
                            model = Model(cfg, device=d, seed=0, tp_ctx=ctx)
                            model.load_flat(flat0.to(d))
                        trainer = Trainer(model, TrainConfig(
                            scheme=scheme, optim=OptimConfig(name="adamw",
                                                             lr=1e-3),
                            update_milestones=(0,), update_every=0, workers=1),
                            seed=0, transport=grid.transport)
                        cuda.reset_launches()
                        TPStats.reset()
                        t0 = time.perf_counter()
                        m = trainer.train_step(
                            {k: v.to(d) for k, v in batch.items()},
                            u=[u.to(d)])
                        res.append({"loss": m["loss"],
                                    "grad": trainer.grads[0].float().cpu(),
                                    "ms": (time.perf_counter() - t0) * 1e3,
                                    "launches": dict(cuda.LAUNCHES),
                                    "tp_calls": TPStats.calls})
                    cpu_r, card_r = res
                    rel = (abs(card_r["loss"] - cpu_r["loss"])
                           / abs(cpu_r["loss"]))
                    gerr = float((card_r["grad"] - cpu_r["grad"]).abs().max()
                                 / cpu_r["grad"].abs().max())
                    rec["configs"][arch] = {
                        "d": on_cpu.d, "loss_cpu": cpu_r["loss"],
                        "loss_card": card_r["loss"], "loss_rel": rel,
                        "grad_err": gerr, "ms_cpu": cpu_r["ms"],
                        "ms_card": card_r["ms"],
                        "launches": card_r["launches"],
                        "tp_calls": card_r["tp_calls"]}
                    del on_cpu, model, trainer, res, flat0
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()


# phase Q1's SMOKE configs at tp = 2, card against CPU; qwen1.5's 5 heads
# pad to 6 (one padding head on model rank 1)
Q_SMOKE = {"rwkv6-7b": {}, JAMBA: {}, "mixtral-8x7b": {}, VLM: {},
           "qwen1.5-32b": {"num_heads": 5, "num_kv_heads": 1,
                           "head_dim": 32}}


def _cache_bytes(caches) -> int:
    return sum(t.nbytes for c in caches for t in c)


def serve_tp(grid) -> dict:
    """Phase Q1 (``tp_check``'s ``serve`` mode, a model group of 2 gloo
    ranks sharing cuda:0).  llama3.2-1b whole at tp = 2 (float32
    parameters, bf16 compute, ``trained_like`` weights from seed 0)
    through ``make_prefill_step``/``make_decode_step`` with 2 cache
    shards, phase K's setting: an 8 x 1024 prefill (warmed up, then
    timed), 63 greedy decode steps each synchronised, then one more step
    with the model group's collectives timed; the prefill ms, each step's
    ms, the collectives of a step (all-reduces and all-gathers: calls,
    bytes, ms), the caches' bytes and the peak memory of this rank.  At
    float32 compute: tp = 1 on the same weights, and tp = 2 on them cut
    in two (``split_tp1``), a 2 x 1024 prefill and 4 teacher-forced
    steps each, the logits' largest error over the largest logit and
    the caches gathered at the end against tp = 1's.  Then each of
    ``Q_SMOKE``'s configs at tp = 2, ``trained_like`` weights: the
    prefill of 2 x 128 and 8 teacher-forced steps on the CPU and on the
    card (``_serve_steps``, ``_steps_off``); and the launches (none)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels import cuda
    from repro_torch.models.layers import TPStats
    from repro_torch.models.transformer import Model
    from repro_torch.serve import (ServeConfig, make_decode_step,
                                   make_prefill_step)
    dev, ctx = grid.device, grid.tp_ctx
    cuda.reset_launches()
    cfg = configs.get_config("llama3.2-1b")
    batch, prompt, gen = 8, 1024, 64
    torch.cuda.empty_cache()
    model = Model(cfg, device=dev, seed=0, tp_ctx=ctx)
    trained_like(model, torch.Generator(device=dev).manual_seed(19))
    g = torch.Generator(device=dev).manual_seed(20)
    ids = torch.randint(0, cfg.vocab_size, (batch, prompt + 4), generator=g,
                        device=dev)
    scfg = ServeConfig(max_len=prompt + gen)
    prefill = make_prefill_step(model, scfg, cache_shards=ctx.tp)
    decode = make_decode_step(model, scfg, cache_shards=ctx.tp)
    prefill(ids[:, :prompt])                  # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tok, caches = prefill(ids[:, :prompt])
    torch.cuda.synchronize()
    rec = {"d": model.d, "compute": cfg.compute_dtype, "batch": batch,
           "prompt": prompt, "gen": gen,
           "prefill_ms": (time.perf_counter() - t0) * 1e3,
           "cache_bytes": _cache_bytes(caches), "step_ms": []}
    out = [tok]
    for i in range(gen - 1):
        pos = torch.full((batch,), prompt + i, dtype=torch.int32, device=dev)
        TPStats.reset()
        t0 = time.perf_counter()
        tok, caches = decode(tok, pos, caches)
        torch.cuda.synchronize()
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out.append(tok)
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    rec["tokens"] = torch.stack(out, dim=1).tolist()
    TPStats.reset()
    TPStats.timed = True
    decode(tok, torch.full((batch,), prompt + gen - 1, dtype=torch.int32,
                           device=dev), caches)
    TPStats.timed = False
    rec["collectives"] = {k: getattr(TPStats, k) for k in (
        "calls", "bytes", "ms", "gather_calls", "gather_bytes", "gather_ms")}
    del model, caches, prefill, decode
    torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    rows = ids[:2]

    def chain(m):
        """The logits of a 2 x 1024 prefill and 4 teacher-forced steps,
        and the caches after them, gathered to the global layout."""
        logits, caches = m.prefill(rows[:, :prompt], max_len=prompt + 4,
                                   cache_shards=m.tp)
        steps = [logits]
        for t in range(prompt, prompt + 4):
            pos = torch.full((2,), t, dtype=torch.int32, device=dev)
            logits, caches = m.decode(rows[:, t], pos, caches)
            steps.append(logits)
        return steps, m.gather_caches(caches)

    one = Model(cfg32, device=dev, seed=0)
    want, want_caches = chain(one)
    mine = split_tp1(one.flat, cfg32, ctx.tp, ctx.rank)
    del one
    torch.cuda.empty_cache()
    two = Model(cfg32, device=dev, seed=0, tp_ctx=ctx)
    two.load_flat(mine)
    del mine
    got, got_caches = chain(two)
    rec["f32_logits"] = max(_max_rel(a, b) for a, b in zip(got, want))
    rec["f32_caches"] = max(_max_rel(a, b) for x, y in zip(got_caches,
                                                            want_caches)
                            for a, b in zip(x, y))
    del two, want_caches, got_caches
    torch.cuda.empty_cache()

    toks = np.random.default_rng(18).integers(0, 509, (2, 136))
    rec["smoke"] = {}
    for arch, over in Q_SMOKE.items():
        cfg = dataclasses.replace(configs.get_smoke_config(arch), **over)
        rng = torch.Generator().manual_seed(18)
        on_cpu = Model(cfg, device="cpu", seed=0, tp_ctx=ctx)
        trained_like(on_cpu, rng)
        vision = (torch.randn(2, cfg.num_image_tokens, cfg.d_model,
                              generator=rng)
                  if cfg.cross_attn_every else None)
        on_card = Model(cfg, device=dev, seed=0, tp_ctx=ctx)
        on_card.load_flat(on_cpu.flat.to(dev))
        ids = torch.from_numpy(toks % cfg.vocab_size)
        t0 = time.perf_counter()
        cpu = _serve_steps(on_cpu, ids, vision, 128, 8, 136)
        t1 = time.perf_counter()
        card = _serve_steps(on_card, ids.to(dev), None if vision is None
                            else vision.to(dev), 128, 8, 136)
        t2 = time.perf_counter()
        lerr, cerr = _steps_off(card, cpu)
        rec["smoke"][arch] = {"name": cfg.name, "logits": lerr,
                              "caches": cerr, "heads": on_card.dims.n_heads,
                              "cpu_s": t1 - t0, "card_s": t2 - t1}
        del on_cpu, on_card, cpu, card
    rec["launches"] = dict(cuda.LAUNCHES)
    return rec


def serve_grid() -> dict:
    """Phase Q2, a run of ``rank_run`` (``--rank-run OUT ... --then
    --serve-grid``) in phase P1's 4 gloo ranks sharing cuda:0, which keep
    their group (2 data x 2 model).  First the serve launcher's ``run``
    at ``--tp 2`` (llama3.2's SMOKE config, 4 x 32 prompt, 16 tokens:
    each data rank's 2 rows), then its model group alone serving the
    whole batch with the same weights, as a 2-rank run of the launcher
    would; then the long-context layout: llama3.2-1b at full width cut
    to 4 layers, float32, batch 1, ``seq_shard_axes=("data", "model")``
    with 4 cache shards (this rank's shard: its world rank), a
    4096-token prompt (timed) and 8 decode steps (each timed), the
    prefill's and each step's logits against one full forward of the
    whole sequence with the same weights (``_full_logits`` at each
    position).  Returns this rank's record."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.kernels import cuda
    from repro_torch.launch import serve
    from repro_torch.models.layers import shard_of
    from repro_torch.models.transformer import Model
    from repro_torch.serve import (ServeConfig, make_decode_step,
                                   make_prefill_step)
    args = serve.parse_args(["--tp", "2", "--device", "cuda:0", "--backend",
                             "gloo", "--batch", "4", "--prompt-len", "32",
                             "--gen", "16"])
    res = serve.run(args)
    m, cfg = res["model"], res["config"]
    dev = m.flat.device
    rec = {"rank": dist.get_rank(), "rows": list(res["rows"]),
           "tokens": res["tokens"].tolist(),
           "launcher_ms": [res["prefill_ms"], res["decode_ms"]]}
    whole = Model(cfg, device=dev, seed=serve.SEED, tp_ctx=m.ctx)
    whole.load_flat(m.flat)
    scfg = ServeConfig(max_len=args.prompt_len + args.gen)
    prefill = make_prefill_step(whole, scfg, cache_shards=m.tp)
    decode = make_decode_step(whole, scfg, cache_shards=m.tp)
    tok, caches = prefill(serve.prompts(cfg, args.batch, args.prompt_len,
                                        dev))
    toks = [tok]
    for i in range(args.gen - 1):
        pos = torch.full((args.batch,), args.prompt_len + i,
                         dtype=torch.int32, device=dev)
        tok, caches = decode(tok, pos, caches)
        toks.append(tok)
    rec["whole"] = torch.stack(toks, dim=1).tolist()
    del whole, caches

    cfg = dataclasses.replace(configs.get_config("llama3.2-1b"),
                              num_layers=4, compute_dtype="float32")
    lc = Model(cfg, device=dev, seed=0, tp_ctx=m.ctx,
               data_ctx=m.groups["data"], seq_shard_axes=("data", "model"))
    prompt, steps = 4096, 8
    g = torch.Generator(device=dev).manual_seed(21)
    ids = torch.randint(0, cfg.vocab_size, (1, prompt + steps), generator=g,
                        device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = lc.prefill(ids[:, :prompt], max_len=prompt + steps,
                                cache_shards=4)
    torch.cuda.synchronize()
    rec.update(shard=shard_of(lc.seq_ctxs), lc_d=lc.d,
               prefill_ms=(time.perf_counter() - t0) * 1e3,
               cache_bytes=_cache_bytes(caches), step_ms=[])
    got = [logits]
    for t in range(prompt, prompt + steps):
        pos = torch.full((1,), t, dtype=torch.int32, device=dev)
        t0 = time.perf_counter()
        logits, caches = lc.decode(ids[:, t], pos, caches)
        torch.cuda.synchronize()
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        got.append(logits)
    want = _full_logits(lc, ids, None, list(range(prompt - 1,
                                                  prompt + steps)))
    rec["errs"] = [_max_rel(a, b) for a, b in zip(got, want)]
    rec["launches"] = dict(cuda.LAUNCHES)
    return rec


def phase_q(smi: str, q1: list[dict], q2: list[dict],
            k_cache_bytes: int) -> dict:
    """Phase Q: serving at tp > 1.  Q1 (``serve_tp``, run in phase P's
    pair of ranks): llama3.2-1b whole at tp = 2, phase K's setting; each
    rank holds half of phase K's attention caches (``k_cache_bytes``);
    the float32 tp = 2 chain within 1e-4 of the largest logit of tp =
    1's (phase K's band), its gathered caches too; the SMOKE configs at
    tp = 2 card against CPU within the serve check's bands.  Q2
    (``serve_grid``, run in phase P1's 4 gloo ranks): the launcher's data
    ranks' rows equal the model group's serve of the whole batch, and the
    long-context layout within 1e-4 of the full forward.  Neither
    launches a kernel."""
    import statistics
    out = {"card": smi}
    for r in q1:
        med = statistics.median(r["step_ms"][1:])
        spread = max(r["step_ms"][1:]) - min(r["step_ms"][1:])
        tps = r["batch"] * (r["gen"] - 1) / (sum(r["step_ms"]) / 1e3)
        c = r["collectives"]
        check(r["tokens"] == q1[0]["tokens"], "phase Q1: the ranks' tokens "
              "differ")
        check(all(0 <= t < 128256 for row in r["tokens"] for t in row)
              and len(r["tokens"]) == r["batch"]
              and len(r["tokens"][0]) == r["gen"], "phase Q1 tokens")
        check(2 * r["cache_bytes"] == k_cache_bytes, f"phase Q1: a rank's "
              f"caches {r['cache_bytes']} B, phase K's {k_cache_bytes} B")
        check(r["f32_logits"] <= 1e-4 and r["f32_caches"] <= 1e-4,
              f"phase Q1: float32 tp = 2 off tp = 1 by {r['f32_logits']} "
              f"(logits), {r['f32_caches']} (caches)")
        check(not any(r["launches"].values()), f"phase Q1 launched kernels: "
              f"{r['launches']}")
        print(f"phase Q1 rank {q1.index(r)}: llama3.2-1b whole at tp = 2 "
              f"(d = {r['d']} a rank, {r['compute']} compute), "
              f"{r['batch']} x {r['prompt']} prompt: prefill "
              f"{r['prefill_ms']:.1f} ms; "
              f"{r['gen'] - 1} decode steps: first {r['step_ms'][0]:.2f} ms, "
              f"then median {med:.2f} ms (spread {spread:.2f}), {tps:.1f} "
              f"tokens/s; a step's collectives: {c['calls']} all-reduces "
              f"({c['bytes'] / 2**10:.1f} KiB, {c['ms']:.2f} ms), "
              f"{c['gather_calls']} all-gathers "
              f"({c['gather_bytes'] / 2**10:.1f} KiB, {c['gather_ms']:.2f} "
              f"ms); caches {r['cache_bytes'] / 2**20:.1f} MiB (phase K: "
              f"{k_cache_bytes / 2**20:.1f}), peak "
              f"{r['peak_bytes'] / 2**30:.2f} GiB; float32 against tp = 1: "
              f"logits {r['f32_logits']:.3g}, "
              f"caches {r['f32_caches']:.3g} of the largest entry ({smi})",
              flush=True)
        for arch, sm in r["smoke"].items():
            band = 5e-5 if arch == JAMBA else 1e-5
            check(sm["logits"] <= band and sm["caches"] <= band,
                  f"phase Q1 {arch} at tp = 2: logits {sm['logits']}, "
                  f"caches {sm['caches']} off the CPU's (band {band})")
            print(f"phase Q1 rank {q1.index(r)} {sm['name']} at tp = 2 "
                  f"({sm['heads']} q heads): card against CPU, logits "
                  f"{sm['logits']:.2g}, caches {sm['caches']:.2g} of the "
                  f"largest entry (band {band}); CPU {sm['cpu_s']:.1f} s, "
                  f"card {sm['card_s']:.1f} s", flush=True)
    out["Q1"] = q1
    for r in q2:
        rows = r["rows"]
        check(rows == [2 * (r["rank"] // 2), 2 * (r["rank"] // 2) + 1],
              f"phase Q2 rank {r['rank']} rows {rows}")
        check(r["tokens"] == [r["whole"][b] for b in rows], f"phase Q2 rank "
              f"{r['rank']}: the launcher's rows {r['tokens']} against the "
              f"whole batch's {r['whole']}")
        check(r["shard"] == [4, r["rank"]], f"phase Q2 shard {r['shard']}")
        check(max(r["errs"]) <= 1e-4, f"phase Q2 rank {r['rank']}: the "
              f"long-context decode off the full forward by {r['errs']}")
        check(not any(r["launches"].values()), f"phase Q2 launched kernels: "
              f"{r['launches']}")
        print(f"phase Q2 rank {r['rank']} (data {r['rank'] // 2}, model "
              f"{r['rank'] % 2}): the launcher at --tp 2 served rows {rows} "
              f"as the model group's whole batch; long context (llama3.2-1b "
              f"at full width, 4 layers, d = {r['lc_d']} a rank, float32, "
              f"cache shard {r['shard'][1]} of 4, "
              f"{r['cache_bytes'] / 2**20:.2f} MiB): prefill of 4096 "
              f"{r['prefill_ms']:.1f} ms, decode steps ms "
              f"{[round(t, 2) for t in r['step_ms']]}, against the full "
              f"forward {max(r['errs']):.3g} of the largest logit (band "
              f"1e-4) ({smi})", flush=True)
    out["Q2"] = q2
    return out


def phase_p(smi: str, ops, ref, lv, shapes) -> dict:
    """Phase P: tensor parallelism, each run a subprocess while this
    process holds no large tensor on the card.  P1: qwen3-0.6b whole
    through ``--tp 2`` on 4 gloo ranks sharing cuda:0 (2 data x 2 model),
    phase H's setting at 2 data workers (2 x 1024 uniform tokens a
    worker, ALQ 3-bit, buckets of 8192, AdamW, a level update at step 1,
    3 steps): the model ranks of a data rank report bit-equal losses,
    the data ranks of a model rank hold bit-equal parameters after every
    step (their fingerprints), finite losses, every rank launches all
    four kernels, d = D_P a rank; per rank the steps, stages, the model
    group's all-reduces (calls, bytes, ms), peak memory and launches;
    before it the kernels at P1's shapes against their plain versions.
    P1f: the float32 tp = 2 pass against tp = 1 (``tp_check f32``,
    whose child then runs P2's ``p2`` in the same two processes): the
    loss within rtol 1e-5, the sharded leaves' gradients and the
    replicated leaves' rank sums at 2x tp = 1's within 1e-4 of each
    leaf's largest entry.  P2: one step of each of ``P2_BANDS``'s SMOKE
    configs at tp = 2, card against CPU within the earlier card bands,
    every kernel launched on the card."""
    import torch
    torch.cuda.empty_cache()
    out = {"card": smi}
    phase_shapes(ops, ref, lv, shapes, "P", NB_P, m=2)
    argv = ["--arch", "qwen3-0.6b", "--tp", "2", "--batch", "4", "--seq",
            "1024", "--data", "uniform", "--scheme", "alq", "--bits", "3",
            "--bucket", str(BS_B), "--optim", "adamw", "--lr", "1e-4",
            "--update-at", "1", "--time-stages", "--steps", "3",
            "--device", "cuda:0", "--backend", "gloo"]
    # phase Q2 rides the same four ranks after P1 (``serve_grid``)
    recs, out["Q2"] = _runs("P", "P1-Q2", [argv, ["--serve-grid"]], 4)
    for r in recs:
        check(r["d"] == D_P and r["layers"] == 28,
              f"phase P1 rank {r['rank']}: d {r['d']}, {r['layers']} layers")
        check(r["model_rank"] == r["rank"] % 2, "phase P1 grid layout")
        check(all(math.isfinite(x) for x in r["loss"]),
              f"phase P1 losses {r['loss']}")
        check(all(r["launches"].get(k, 0) > 0 for k in (
            "quantize", "dequantize", "dequantize_mean", "bucket_stats")),
            f"phase P1 rank {r['rank']} launches {r['launches']}")
        check(len(r["fingerprints"]) == 3, "phase P1 fingerprints")
    for d in range(2):
        a, b = recs[2 * d], recs[2 * d + 1]
        check(a["loss"] == b["loss"], f"phase P1 data rank {d}: model "
              f"ranks' losses {a['loss']} and {b['loss']}")
    for m in range(2):
        a, b = recs[m], recs[2 + m]
        check(a["fingerprints"] == b["fingerprints"], f"phase P1 model "
              f"rank {m}: the data ranks' parameters differ")
        check(a["digest"] == b["digest"], f"phase P1 model rank {m} sha256")
    check(recs[0]["fingerprints"] != recs[1]["fingerprints"],
          "phase P1: the model ranks hold the same parameters")
    for r in recs:
        split = "; ".join(", ".join(f"{k} {v:.1f}" for k, v in st.items())
                          for st in r["stage_ms"])
        tp = "; ".join(f"{t['calls']} calls, {t['bytes'] / 2**20:.1f} MiB, "
                       f"{t['ms']:.1f} ms" for t in r["tp"])
        print(f"phase P1 rank {r['rank']} (data {r['rank'] // 2}, model "
              f"{r['model_rank']}): d={r['d']}, steps ms "
              f"{[round(t, 1) for t in r['step_ms']]}, stages ms by step "
              f"[{split}], TP all-reduces by step [{tp}], peak memory "
              f"{r['peak_bytes'] / 2**30:.2f} GiB, launches {r['launches']}"
              f", process {r['wall_s']:.1f} s", flush=True)
    print(f"phase P1: 4 gloo ranks, losses {recs[0]['loss']} on every "
          f"rank; each model rank's data ranks bit-equal after every step",
          flush=True)
    out["P1"] = recs
    # phase Q1 rides the same pair of ranks (``serve``), reported by phase_q
    f32 = p2 = _child_runs("P", "--tp-check", "f32-p2-q1",
                           ["f32", "p2", "serve"], 2)
    out["Q1"] = [r.pop("serve") for r in f32]
    out["Q1_wall_s"] = f32[0]["wall_s"]
    for r in f32:
        rel = abs(r["loss2"] - r["loss1"]) / abs(r["loss1"])
        check(rel <= 1e-5, f"phase P1f rank {r['rank']}: loss tp=2 "
              f"{r['loss2']} tp=1 {r['loss1']}")
        check(max(r["worst"].values()) <= 1e-4, f"phase P1f rank "
              f"{r['rank']}: gradients off 2x tp=1's by {r['worst']}")
        print(f"phase P1f rank {r['rank']}: float32 loss tp=2 "
              f"{r['loss2']:.7f} tp=1 {r['loss1']:.7f} (rel {rel:.2g}); "
              f"against 2x the tp=1 gradient, sharded leaves within "
              f"{r['worst']['sharded']:.2g}, replicated leaves' rank sums "
              f"within {r['worst']['replicated']:.2g} of the largest entry; "
              f"grad ms tp=1 {r['ms1']:.1f}, tp=2 {r['ms2']:.1f} "
              f"({r['tp_calls']} all-reduces, {r['tp_bytes'] / 2**20:.1f} "
              f"MiB), peak {r['peak_bytes'] / 2**30:.2f} GiB", flush=True)
    out["P1f"] = f32
    for arch, (loss_rtol, grad_rtol) in P2_BANDS.items():
        for r in p2:
            c = r["configs"][arch]
            check(c["loss_rel"] <= loss_rtol and c["grad_err"] <= grad_rtol,
                  f"phase P2 {arch} rank {r['rank']}: loss rel "
                  f"{c['loss_rel']}, gradient {c['grad_err']}")
            check(all(c["launches"].get(k, 0) > 0 for k in (
                "quantize", "dequantize", "bucket_stats")),
                f"phase P2 {arch} launches {c['launches']}")
            print(f"phase P2 {arch} rank {r['rank']}: d={c['d']}, loss card "
                  f"{c['loss_card']:.6f} CPU {c['loss_cpu']:.6f} (rel "
                  f"{c['loss_rel']:.2g}), gradient within "
                  f"{c['grad_err']:.2g}, step ms card {c['ms_card']:.1f} "
                  f"CPU {c['ms_cpu']:.1f}, {c['tp_calls']} all-reduces, "
                  f"launches {c['launches']}", flush=True)
    out["P2"] = p2
    return out


def meta_h():
    """Phase H's update step on the meta device, built as the launcher
    builds it (qwen3-0.6b whole, 4 stacked workers x 2 x 1024, ALQ 3-bit,
    buckets of 8192, AdamW, the level update at step 1): its
    ``op_cost.Cost``, the peak over building and the step."""
    import torch
    from repro_torch import configs
    from repro_torch.core.schemes import QuantScheme
    from repro_torch.launch import op_cost
    from repro_torch.models.transformer import Model
    from repro_torch.train.optim import OptimConfig
    from repro_torch.train.train_step import TrainConfig, Trainer
    with op_cost.CostMode() as mode:
        model = Model(configs.get_config("qwen3-0.6b"), device="meta",
                      seed=0)
        check(model.d == D_H, f"phase R1: H's meta d = {model.d}")
        trainer = Trainer(model, TrainConfig(
            scheme=QuantScheme(name="alq", bits=3, bucket_size=BS_B),
            optim=OptimConfig(name="adamw", lr=1e-4, weight_decay=0.0),
            update_milestones=(1,), update_every=0, workers=M_B), seed=0)
        trainer.step = 1                 # the card's update step
        toks = torch.empty((2 * M_B, 1025), dtype=torch.int64,
                           device="meta")
        built = mode.cost.peak_bytes
        mode.reset()
        trainer.step_tensors({"ids": toks[:, :-1], "labels": toks[:, 1:]})
    return mode.cost, max(built, mode.cost.peak_bytes)


def meta_k():
    """Phase K on the meta device: llama3.2-1b whole, the 8 x 1028 ids,
    the prefill of 8 x 1024 and one decode step (max_len 1088): the
    ``op_cost.Cost`` of the two steps and the peak over building and
    both."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import op_cost
    from repro_torch.models.transformer import Model
    from repro_torch.serve import (ServeConfig, make_decode_step,
                                   make_prefill_step)
    with op_cost.CostMode() as mode:
        model = Model(configs.get_config("llama3.2-1b"), device="meta",
                      seed=0)
        check(model.d == D_K, f"phase R1: K's meta d = {model.d}")
        ids = torch.empty((8, 1024 + 4), dtype=torch.int64, device="meta")
        scfg = ServeConfig(max_len=1024 + 64)
        prefill = make_prefill_step(model, scfg)
        decode = make_decode_step(model, scfg)
        built = mode.cost.peak_bytes
        mode.reset()
        tok, caches = prefill(ids[:, :1024])
        decode(tok, torch.empty((8,), dtype=torch.int32, device="meta"),
               caches)
    return mode.cost, max(built, mode.cost.peak_bytes)


def phase_r(smi: str, card: dict) -> dict:
    """Phase R, the dry run's check on the card's host.  R2 starts first,
    as a child (``python -m repro_torch.launch.dryrun`` at llama3.2-1b's
    three shapes on the single-pod layout; every record must be ok) and
    runs while R1 counts phase H's update step and phase K's prefill and
    decode step on the meta device (``launch.op_cost``).  Each meta peak
    must lie within 10% of the peak the card measured for that phase in
    this run, less what the card held before the phase (``PEAK_BASE``);
    H's counted FLOPs over its measured update step give a rate and a
    share of the dense bf16 peak.  ``card``: H's and K's peaks (bytes)
    and H's update step (ms)."""
    from repro_torch.launch.roofline import PEAK_FLOPS
    out_dir = os.path.join(ROOT, "build", "phase_r")
    if os.path.isdir(out_dir):          # records of an earlier run
        for fn in os.listdir(out_dir):
            os.remove(os.path.join(out_dir, fn))
    child = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *R2_ARGV,
         "--out", out_dir],
        cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=(
            os.path.join(ROOT, "src") + os.pathsep
            + os.environ.get("PYTHONPATH", ""))),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        t0 = time.perf_counter()
        cost_h, peak_h = meta_h()
        cost_k, peak_k = meta_k()
        r1_s = time.perf_counter() - t0
        out, _ = child.communicate(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    rec = {"card": smi, "r1_s": r1_s}
    for name, cost, meta_peak in (("H", cost_h, peak_h),
                                  ("K", cost_k, peak_k)):
        own = card[name]["peak_bytes"] - PEAK_BASE[name]
        off = meta_peak / own - 1.0
        print(f"phase R1: {name} on the meta device: peak "
              f"{meta_peak / 2**30:.3f} GiB against the card's "
              f"{own / 2**30:.3f} GiB ({card[name]['peak_bytes'] / 2**30:.3f}"
              f" less {PEAK_BASE[name] / 2**30:.3f} held before), "
              f"{100 * off:+.2f}%; {cost.flops:.6g} FLOPs "
              f"({cost.matmul_flops:.6g} in matmuls), "
              f"{cost.hbm_bytes:.6g} HBM bytes", flush=True)
        check(abs(off) <= PEAK_BAND, f"phase R1: {name}'s meta peak "
              f"{meta_peak} is {100 * off:+.2f}% off the card's {own}")
        rec[name] = {"meta_peak_bytes": meta_peak, "card_peak_bytes": own,
                     "base_bytes": PEAK_BASE[name], "off": off,
                     "flops": cost.flops, "matmul_flops": cost.matmul_flops,
                     "hbm_bytes": cost.hbm_bytes}
    rate = cost_h.flops / (card["H"]["step_ms"] / 1e3)
    rec["H"].update(step_ms=card["H"]["step_ms"], flops_per_s=rate,
                    bf16_share=rate / PEAK_FLOPS)
    print(f"phase R1: H's update step, {cost_h.flops:.6g} counted FLOPs "
          f"in {card['H']['step_ms']:.1f} ms: {rate / 1e12:.2f} TFLOP/s, "
          f"{100 * rate / PEAK_FLOPS:.2f}% of the dense bf16 "
          f"{PEAK_FLOPS / 1e12:.1f} TFLOP/s of an H100 SXM5 at 700 W "
          f"(data sheet); card: {smi}; counted on the host in {r1_s:.1f} s",
          flush=True)
    print(out.strip(), flush=True)
    check(child.returncode == 0, f"phase R2: the dry run exited "
          f"{child.returncode}")
    recs = []
    for fn in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, fn)) as f:
            recs.append(json.load(f))
    check(len(recs) == 3 and all(r["ok"] for r in recs),
          f"phase R2: records {[(r['shape'], r['ok']) for r in recs]}")
    rec["R2"] = [{k: r[k] for k in ("shape", "microbatches", "run_s",
                                    "bytes_per_device", "roofline",
                                    "model_flops_per_device",
                                    "useful_flops_ratio")} for r in recs]
    return rec


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    try:
        from repro_torch import compress, configs
        from repro_torch import core
        from repro_torch.compress import SparseCodec
        from repro_torch.core import levels as lv
        from repro_torch.core.codec import (
            codec_for_scheme, make_codec, requant_codec, resample_levels)
        from repro_torch.core.packing import from_int32_bits, wire_bits_for
        from repro_torch.core.schemes import QuantScheme
        from repro_torch.dist import faults, sync, transport
        from repro_torch.kernels import cuda, ops, ref
        from repro_torch.kernels.bucket_stats import bucket_stats_cuda
        from repro_torch.kernels.quantize import quantize_cuda
        from repro_torch.launch import train
        from repro_torch.models import attention, layers
        from repro_torch.models.transformer import Model
        from repro_torch import sim
        from repro_torch.sim import __main__ as sim_main
        from repro_torch.sim import topology
    except ImportError as e:
        fail(f"the port is not importable from {ROOT}/src: {e}")
    if sys.argv[1:2] == ["--rank-run"]:
        rank_run(sys.argv[2:])
        return
    if sys.argv[1:2] == ["--fsdp-run"]:
        fsdp_run(sys.argv[2:])
        return
    if sys.argv[1:2] == ["--tp-check"]:
        tp_check(sys.argv[2:])
        return
    if sys.argv[1:2] == ["--grad-twice"]:
        # determinism_check's subprocess (CUBLAS_WORKSPACE_CONFIG is set)
        torch.use_deterministic_algorithms(True)
        same, diff, ms, *_ = grad_twice(configs, Model, sys.argv[2])
        check(same, f"two backward passes differ by {diff} or are not "
              "finite")
        print(f"finite and bit-equal, no op refused (second pass "
              f"{ms:.1f} ms)")
        return

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    def lap(what: str) -> None:
        print(f"elapsed {time.perf_counter() - t_start:.1f} s after {what}",
              flush=True)

    t0 = time.perf_counter()
    built = cuda.build()
    print(f"build: {json.dumps(built)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name in cuda.SOURCES:
        print(build_line(name, built.get(name), cuda.ptxas_report(name)),
              flush=True)

    kernel_grid(ops, ref, lv)
    layout_grid(ref, lv, cuda, quantize_cuda, bucket_stats_cuda)
    kernels = main_path_kernels(ops, ref, lv, cuda, codec_for_scheme,
                                QuantScheme)
    shapes, t_select = slice_shapes(ops, ref, lv, codec_for_scheme,
                                    QuantScheme, SparseCodec, resample_levels)
    mean_order = decode_shapes(ops, ref, lv, shapes)
    sim_shapes(ops, ref, lv, cuda, shapes)
    phase_shapes(ops, ref, lv, shapes, "H", NB_H)
    phase_shapes(ops, ref, lv, shapes, "I", NB_I)
    lap("the build and the kernels")
    fsdp_shapes(ops, ref, lv, shapes)
    sync_check(sync, compress, QuantScheme, make_codec)
    entropy_words_check(ops, QuantScheme, make_codec)
    table_check(QuantScheme, make_codec, from_int32_bits)
    fault_check(sync, faults, transport, QuantScheme, make_codec,
                wire_bits_for)
    sim_check(topology, compress, QuantScheme, make_codec)
    api_check(core, ref, lv, cuda)
    dense_config_check(train, configs, Model, cuda)
    moe_rwkv_config_check(train, configs, Model, cuda)
    counts_smoke = hybrid_vlm_config_check(train, configs, Model, cuda)
    counts_v = vision_step_check(configs, Model, cuda)
    determinism_check(configs, Model, "llama3.2-1b")
    moe_width = moe_width_check(configs, Model)
    rwkv_twice = determinism_check(configs, Model, "rwkv6-7b")
    lap("the checks")

    # ---- phase A ----
    cuda.reset_launches()
    res = train.run(train.parse_args([
        "--arch", "paper-proxy", "--workers", "4", "--scheme", "alq",
        "--bits", "3", "--bucket", "1024", "--update-at", "2,10",
        "--steps", "16", "--lr", "2e-3", "--data", "markov"]))
    counts_a = dict(cuda.LAUNCHES)
    lap("phase A")
    hist = res["history"]
    losses = [h["loss"] for h in hist]
    check(all(math.isfinite(x) for x in losses), "phase A loss not finite")
    check(sum(losses[-4:]) / 4 < sum(losses[:4]) / 4 - 0.05,
          f"phase A loss did not fall: {losses}")
    check(hist[1]["levels"] == hist[0]["levels"]
          and hist[2]["levels"] != hist[1]["levels"],
          "phase A levels did not move at step 2 only")
    bits = hist[-1]["comm_bits_per_coord"]
    check(abs(bits - 4.1) < 0.05, f"phase A bits/coord {bits}")
    check(res["num_updates"] == 2, "phase A level updates")
    check(all(counts_a.get(k, 0) > 0 for k in cuda.KERNELS),
          f"phase A kernel launches {counts_a}")
    print(f"phase A: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"{bits:.3f} bits/coord, levels {hist[-1]['levels']}, "
          f"launches {counts_a}", flush=True)

    full = ["--arch", "llama3.2-1b", "--layers", "4", "--workers", str(M_B),
            "--batch", str(2 * M_B), "--seq", "1024", "--data", "uniform",
            "--scheme", "alq", "--bits", "3", "--bucket", str(BS_B),
            "--optim", "adamw", "--lr", "1e-4", "--update-at", "1",
            "--time-stages"]
    phases = {}

    # ---- phase B: all_gather, plain ----
    res, counts_b, layouts_b, peak = run_phase(
        train, "B", full + ["--steps", "5"], cuda.KERNELS, cuda)
    check(all(layouts_b.get(f"{k}/regs", 0) == counts_b[k]
              for k in ("quantize", "bucket_stats")),
          f"phase B bucket layouts {layouts_b}")
    print(f"phase B: d={res['d']}, peak memory {peak / 2**30:.2f} GiB in "
          f"stage {res['peak_stage']}, launches {counts_b}, layouts "
          f"{layouts_b}", flush=True)
    phases["B"] = (res, counts_b, layouts_b, peak)

    # ---- phase C: two_phase + ef + integrity ----
    res, counts_c, layouts_c, peak = run_phase(
        train, "C", full + ["--steps", "5", "--sync", "two_phase",
                            "--compress", "ef", "--integrity"],
        cuda.KERNELS, cuda)
    scheme = QuantScheme(bits=3, bucket_size=BS_B)
    codec = make_codec(scheme, integrity=True)
    plan = codec.plan(D_B, shards=M_B)
    plan2 = requant_codec(codec, 8).plan_buckets(plan.shard_nb)
    bcast = 32.0 * (plan2.code_words + plan2.norm_words) / D_B
    hist = res["history"]
    for h in hist:
        check(h["reduce_bits_per_coord"] == plan.bits_per_coord
              and h["broadcast_bits_per_coord"] == bcast
              and h["comm_bits_per_coord"] == plan.bits_per_coord + bcast,
              f"phase C bits/coord {h['comm_bits_per_coord']}")
        check(h["corrupt_fraction"] == 0.0 and h["excluded_workers"] == 0.0,
              f"phase C corrupt buckets on a clean wire: {h}")
        check(math.isfinite(h["residual_norm"]) and h["residual_norm"] > 0,
              "phase C residual norm")
    check(all(layouts_c.get(f"{k}/regs", 0) == counts_c[k]
              for k in ("quantize", "bucket_stats")),
          f"phase C bucket layouts {layouts_c}")
    print(f"phase C: d={res['d']}, peak memory {peak / 2**30:.2f} GiB, "
          f"{hist[-1]['comm_bits_per_coord']:.4f} bits/coord (reduce "
          f"{plan.bits_per_coord:.4f} + broadcast {bcast:.4f}, as planned), "
          f"corrupt share 0, |e| {hist[-1]['residual_norm']:.4g}, "
          f"launches {counts_c}, layouts {layouts_c}", flush=True)
    phases["C"] = (res, counts_c, layouts_c, peak)

    # ---- phase D: all_gather + topk ----
    res, counts_d, layouts_d, peak = run_phase(
        train, "D", full + ["--steps", "3", "--compress", "topk"],
        # the sparse codec decodes, then averages: no dequantize_mean
        ("quantize", "dequantize", "bucket_stats"), cuda)
    hist = res["history"]
    check(all(h["kept_fraction"] == K_D / BS_B for h in hist),
          f"phase D kept fraction {hist[-1]['kept_fraction']}")
    check(layouts_d.get("quantize/smem", 0) == M_B * len(hist),
          f"phase D top-k rows not staged in shared memory: {layouts_d}")
    check(all("select" in h["stage_ms"] for h in hist),
          "phase D stage split lacks the selection")
    print(f"phase D: d={res['d']}, peak memory {peak / 2**30:.2f} GiB, "
          f"kept {hist[-1]['kept_fraction']:.6f} = {K_D}/{BS_B}, "
          f"{hist[-1]['comm_bits_per_coord']:.4f} bits/coord, "
          f"launches {counts_d}, layouts {layouts_d}", flush=True)
    phases["D"] = (res, counts_d, layouts_d, peak)

    # ---- phase E: all_gather over the entropy-coded wire ----
    res, counts_e, layouts_e, peak = run_phase(
        train, "E", full + ["--steps", "3", "--codec", "entropy"],
        ("quantize", "dequantize", "dequantize_mean"), cuda)
    plan_e = make_codec(scheme, "entropy").plan(D_B)
    hist = res["history"]
    for h in hist:
        check(0 < h["comm_bits_per_coord"] <= plan_e.bits_per_coord,
              f"phase E bits/coord {h['comm_bits_per_coord']} against the "
              f"capacity {plan_e.bits_per_coord}")
    print(f"phase E: d={res['d']}, peak memory {peak / 2**30:.2f} GiB, "
          f"measured bits/coord "
          f"{[round(h['comm_bits_per_coord'], 6) for h in hist]} (capacity "
          f"{plan_e.bits_per_coord:.4f}, uniform plan "
          f"{codec_for_scheme(scheme).plan(D_B).bits_per_coord:.4f}), "
          f"Huffman encode (pack) "
          f"{[round(h['stage_ms']['pack'], 1) for h in hist]} ms, decode "
          f"(unpack) {[round(h['stage_ms']['unpack'], 1) for h in hist]} "
          f"ms, launches {counts_e}, layouts {layouts_e}", flush=True)
    phases["E"] = (res, counts_e, layouts_e, peak)

    # ---- phase F: two_phase over the mixed-width wire ----
    res, counts_f, layouts_f, peak = run_phase(
        train, "F", full + ["--steps", "3", "--codec", "mixed_width",
                            "--sync", "two_phase"], cuda.KERNELS, cuda)
    mixed = make_codec(scheme, "mixed_width")
    plan_f = mixed.plan(D_B, shards=M_B)
    plan2 = requant_codec(mixed, 8).plan_buckets(plan_f.shard_nb)
    bcast = 32.0 * (plan2.code_words + plan2.norm_words) / D_B
    uniform_reduce = codec_for_scheme(scheme).plan(
        D_B, shards=M_B).bits_per_coord
    hist = res["history"]
    for h in hist:
        check(h["reduce_bits_per_coord"] == plan_f.bits_per_coord
              and h["broadcast_bits_per_coord"] == bcast,
              f"phase F bits/coord {h['reduce_bits_per_coord']} + "
              f"{h['broadcast_bits_per_coord']}")
    check(abs(plan_f.bits_per_coord - uniform_reduce) < 1e-3,
          "phase F widths are not budget-neutral")
    check(counts_f["quantize"] == (2 * M_B + M_B) * len(hist),
          f"phase F quantize launches {counts_f['quantize']}")
    print(f"phase F: d={res['d']}, peak memory {peak / 2**30:.2f} GiB, "
          f"widths {mixed.widths}, bits/coord reduce "
          f"{plan_f.bits_per_coord:.4f} (uniform 3-bit "
          f"{uniform_reduce:.4f}) + broadcast {bcast:.4f}, as planned, "
          f"launches {counts_f}, layouts {layouts_f}", flush=True)
    phases["F"] = (res, counts_f, layouts_f, peak)
    lap("phases B-F")

    print(json.dumps({"phases": {k: {
        "card": smi, "d": r["d"], "peak_bytes": pk,
        "peak_stage": r["peak_stage"], "stage_peaks": r["stage_peaks"],
        "launches": c, "layouts": ly,
        "steps": [{"step_ms": h["step_ms"], "stage_ms": h["stage_ms"],
                   "loss": h["loss"]} for h in r["history"]]}
        for k, (r, c, ly, pk) in phases.items()},
        "select_ms": t_select, "mean_order": mean_order}), flush=True)
    del phases, res

    # ---- phase G: the cluster simulator at full width ----
    sim_g = phase_g(sim, cuda)
    print(json.dumps({"phase_g": {t: {
        "card": smi, "peak_bytes": pk, "launches": c, "layouts": ly,
        "steps": [{k: s[k] for k in (
            "step_ms", "stage_ms", "loss", "wire_sent_bytes",
            "wire_recv_bytes", "server_bytes", "hops", "sim_time_ms",
            "agg_err", "quant_error")} for s in cell["steps"]]}
        for t, (cell, c, ly, pk) in sim_g.items()}}), flush=True)
    counts_g = [c for _, c, _, _ in sim_g.values()]
    lap("phase G")
    del sim_g

    # ---- phase H: qwen3-0.6b at full width and full depth ----
    res, counts_h, layouts_h, peak = run_phase(
        train, "H", ["--arch", "qwen3-0.6b", "--workers", str(M_B),
                     "--batch", str(2 * M_B), "--seq", "1024", "--data",
                     "uniform", "--scheme", "alq", "--bits", "3", "--bucket",
                     str(BS_B), "--optim", "adamw", "--lr", "1e-4",
                     "--update-at", "1", "--time-stages", "--steps", "3"],
        cuda.KERNELS, cuda, d=D_H)
    check(res["config"].num_layers == 28, "phase H is not at full depth")
    check(all(layouts_h.get(f"{k}/regs", 0) == counts_h[k]
              for k in ("quantize", "bucket_stats")),
          f"phase H bucket layouts {layouts_h}")
    print(f"phase H: d={res['d']}, 28 layers, peak memory "
          f"{peak / 2**30:.2f} GiB in stage {res['peak_stage']}, launches "
          f"{counts_h}, layouts {layouts_h}", flush=True)
    print(json.dumps({"phase_h": {
        "card": smi, "d": res["d"], "peak_bytes": peak,
        "peak_stage": res["peak_stage"], "stage_peaks": res["stage_peaks"],
        "launches": counts_h,
        "layouts": layouts_h,
        "steps": [{"step_ms": h["step_ms"], "stage_ms": h["stage_ms"],
                   "loss": h["loss"]} for h in res["history"]]}}),
        flush=True)
    # for phase R: the peak and the update step (step 1)
    card_r = {"H": {"peak_bytes": peak,
                    "step_ms": res["history"][1]["step_ms"]}}
    del res

    # ---- phase I: rwkv6-7b at full width, 2 of 32 layers ----
    res, counts_i, layouts_i, peak = run_phase(
        train, "I", ["--arch", "rwkv6-7b", "--layers", "2", "--workers",
                     str(M_B), "--batch", str(2 * M_B), "--seq", "1024",
                     "--data", "uniform", "--scheme", "alq", "--bits", "3",
                     "--bucket", str(BS_B), "--optim", "adamw", "--lr",
                     "1e-4", "--update-at", "1", "--time-stages", "--steps",
                     "3"], cuda.KERNELS, cuda, d=D_I)
    check(res["config"].d_model == 4096 and res["config"].num_layers == 2,
          "phase I is not rwkv6-7b at full width and 2 layers")
    check(all(layouts_i.get(f"{k}/regs", 0) == counts_i[k]
              for k in ("quantize", "bucket_stats")),
          f"phase I bucket layouts {layouts_i}")
    print(f"phase I: d={res['d']} ({NB_I} buckets of {BS_B}), 2 layers, "
          f"peak memory {peak / 2**30:.2f} GiB, launches {counts_i}, "
          f"layouts {layouts_i}", flush=True)
    print(json.dumps({"phase_i": {
        "card": smi, "d": res["d"], "peak_bytes": peak, "launches": counts_i,
        "layouts": layouts_i, "moe_width": moe_width,
        "rwkv_twice": rwkv_twice,
        "steps": [{"step_ms": h["step_ms"], "stage_ms": h["stage_ms"],
                   "loss": h["loss"]} for h in res["history"]]}}),
        flush=True)
    cfg_i = res["config"]
    del res

    lap("phases H, I")
    scenario_check(sim_main, cuda)
    resume_check(train)
    micro_check(train)
    lap("the scenario, resume and micro checks")
    # ---- phase J and the Mamba width check: one worker at full width ----
    torch.cuda.empty_cache()
    phase_j = determinism_check(
        configs, Model, VLM, profile="grad, phase J, llama-3.2-vision-11b, 5 "
        "layers, 2 x 1024 tokens + 2 x 1601 image embeddings")
    mamba_width = determinism_check(
        configs, Model, MAMBA_SLOT, profile="grad, Mamba width check, jamba "
        "slot 0, 2 x 1024 hidden states")
    print(json.dumps({"phase_j": phase_j, "mamba_width": mamba_width,
                      "card": smi}), flush=True)
    lap("phase J")
    # ---- serving: the SMOKE configs, then phases K and L at full width ----
    serve_check(configs, Model, cuda)
    phase_k = serve_phase(configs, Model, cuda, "K", "llama3.2-1b", 8, 1024,
                          64, D_K, 1024, 4, every=True, band=1e-4)
    phase_l = serve_phase(configs, Model, cuda, "L", "rwkv6-7b", 4, 512, 32,
                          D_L, 480, 32, every=False, band=3e-4)
    print(json.dumps({"phase_k": phase_k, "phase_l": phase_l, "card": smi}),
          flush=True)
    lap("serving")
    # ---- phase M: one worker a process, in subprocesses ----
    phase_mm = phase_m(smi)
    print(json.dumps({"phase_m": phase_mm}), flush=True)
    counts_m = [r["launches"] for cell in ("M1", "M2", "M3")
                for r in phase_mm[cell]["ranks"]]
    lap("phase M")
    # ---- phase N: remat and the chunked loss; phase O: FSDP ----
    phase_nn = phase_n(configs, Model, layers, smi)
    print(json.dumps({"phase_n": phase_nn}), flush=True)
    lap("phase N")
    phase_oo = phase_o(smi)
    print(json.dumps({"phase_o": phase_oo}), flush=True)
    counts_o = [r["launches"] for r in phase_oo["ranks"]]
    lap("phase O")
    # ---- phase P: tensor parallelism, in subprocesses ----
    phase_pp = phase_p(smi, ops, ref, lv, shapes)
    q1, q2 = phase_pp.pop("Q1"), phase_pp.pop("Q2")
    print(json.dumps({"phase_p": phase_pp}), flush=True)
    lap("phase P (with phase Q's runs)")
    # ---- phase Q: serving at tp > 1 (its runs rode phase P's children) ----
    phase_qq = phase_q(smi, q1, q2, phase_k["cache_bytes"])
    print(json.dumps({"phase_q": phase_qq}), flush=True)
    lap("phase Q")
    # ---- phase R: the dry run on the meta device, against H and K ----
    card_r["K"] = {"peak_bytes": phase_k["peak_bytes"]}
    phase_rr = phase_r(smi, card_r)
    print(json.dumps({"phase_r": phase_rr}), flush=True)
    lap("phase R")
    counts_p = [r["launches"] for r in phase_pp["P1"]] + [
        c["launches"] for r in phase_pp["P2"]
        for c in r["configs"].values()]
    # last: the profiler runs after every timed phase
    print(json.dumps({"attention": attention_timing(attention),
                      "grad_profile": grad_profile(
                          Model, configs.get_config("qwen3-0.6b"),
                          "phase H's model"),
                      "grad_profile_i": grad_profile(
                          Model, cfg_i, "phase I's model"),
                      "card": smi}), flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)

    for k in kernels:
        k["launches"] = sum(c.get(k["name"], 0) for c in (
            counts_b, counts_c, counts_d, counts_e, counts_f, *counts_g,
            counts_h, counts_i, counts_v, *counts_smoke.values(),
            *counts_m, *counts_o, *counts_p))
        k["route"] = "cuda"
        k["shapes"] = shapes.get(k["name"], [])
        check(k["launches"] > 0, f"{k['name']} was not launched by the "
              "phases")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "bound_share", "ms_spread", "shapes")
    print(json.dumps({"kernels": [{key: k[key] for key in keys}
                                  for k in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

  python3 chip_smoke.py

Phases, each of which must pass:
  1. set-up: the card's name and power limit; the three CUDA kernels are
     built with nvcc from ``src/repro_torch/csrc`` (one nvcc each, all at
     once) into ``build/kernels``; each kernel's build line gives its
     registers, shared memory and spill bytes (``-Xptxas -v``);
  2. kernel checks: each kernel against its plain PyTorch version on the
     card, at buckets of 1024 and 8192, f32 and bf16 values, l2 and linf
     norms, 3-bit and 8-bit grids, and in every bucket layout (registers
     at 1024 and 8192, shared memory for odd sizes and unaligned
     pointers, read twice beyond shared memory); then at the shapes
     phase B gives them, where each kernel is timed in 3 rounds (median
     and spread) beside its plain version and its bound;
  3. a 4-worker quantized all-reduce on the card against the same call on
     the CPU (the plain versions), with the same uniforms;
  4. phase A: paper-proxy, markov data, 4 workers, ALQ 3-bit, buckets of
     1024, level updates at steps 2 and 10, 16 steps through the
     training entry point: the loss falls, the levels move after step 2
     and the wire costs about 4.1 bits a coordinate;
  5. phase B: llama3.2-1b at full width cut to 4 layers, 4 workers of 2
     sequences of 1024 tokens, ALQ 3-bit, buckets of 8192, AdamW, a level
     update at step 1, 5 steps: finite loss, time per step and per stage,
     peak memory, and every kernel launched.

Output: per-phase lines, then the kernels' JSON line, then as the last
line {"ok": true, "device": {...}}.  Exits non-zero, with no such last
line, when a phase fails or no CUDA device is present.
"""
from __future__ import annotations

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
BS_B, D_B, M_B = 8192, 768_624_640, 4   # phase B: bucket, d, workers
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


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_grid(ops, ref, lv):
    """Each kernel against its plain version over the small grid."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    worst = {"quantize": 0.0, "dequantize": 0.0, "bucket_stats": 0.0}
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
                        check(torch.equal(d1, d2), "dequantize not exact")
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

    # the decode path: int32 codes of all M workers' streams in one call
    g2 = torch.Generator(device=dev).manual_seed(2)
    c32 = torch.randint(-(L - 1), L, (M_B * nb, BS_B), generator=g2,
                        device=dev, dtype=torch.int32)
    n4 = torch.rand(M_B * nb, generator=g2, device=dev) + 0.1
    got = ops.dequantize_op(c32, n4, levels)
    rows4 = -(-M_B * nb // (chunks * M_B))
    for i in range(0, M_B * nb, rows4):
        check(torch.equal(got[i:i + rows4],
                          ref.dequantize_ref(c32[i:i + rows4],
                                             n4[i:i + rows4], levels)),
              "dequantize at phase B's shape not exact")
    del got
    t = timed_rounds({"one block a bucket":
                      lambda: ops.dequantize_op(c32, n4, levels)}, 3)
    plain = timed(lambda: [ref.dequantize_ref(c32[i:i + rows4],
                                              n4[i:i + rows4], levels)
                           for i in range(0, M_B * nb, rows4)], 1)
    # reads an int32 code, writes an f32 value; ~5 operations an element
    b, by = bound_ms(M_B * n * 8 + M_B * nb * 4, M_B * n * 5)
    out.append(dict(name="dequantize",
                    source="src/repro_torch/csrc/dequantize.cu",
                    replaces="src/repro/kernels/dequantize.py:18",
                    max_abs_err=0.0, timings=t, pick="one block a bucket",
                    plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None,
                    entry="dequantize_kernelIiE",
                    note=f"({M_B * nb}, {BS_B}) int32"))
    del c32, n4
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


def sync_check(sync, QuantScheme, codec_for_scheme):
    """A 4-worker all-reduce on the card (kernels) against the CPU (plain
    versions) with the same gradients and uniforms."""
    import torch
    M, d, bs = 4, 300_000, 1024
    scheme = QuantScheme(bits=3, bucket_size=bs)
    plan = codec_for_scheme(scheme).plan(d)
    g = torch.Generator().manual_seed(3)
    grads = torch.randn(M, d, generator=g) * 1e-2
    u = [torch.rand(plan.nb, bs, generator=g) for _ in range(M)]
    cpu, own, _ = sync.quantized_allreduce(grads, scheme,
                                           scheme.init_state("cpu"),
                                           u=u, return_own=True)
    gpu, m = sync.quantized_allreduce(
        grads.cuda(), scheme, scheme.init_state("cuda"),
        u=[x.cuda() for x in u])
    gpu = gpu.cpu()
    check(gpu.shape == (d,) and bool(torch.isfinite(gpu).all()),
          "all-reduce output shape or finiteness")
    # each decoded term may differ by its norm's last ulp (the norm sums
    # run in another order); a rounding tie may then go the other way
    err = (gpu - cpu).abs()
    scale = own.abs().mean(0)
    close = float((err <= 1e-6 * scale + 1e-12).float().mean())
    check(close >= 0.999, f"all-reduce agrees at only {close:.5f}")
    print(f"sync check: M={M} d={d} card vs CPU: {close:.6f} of coords "
          f"within 1e-6 of their terms, max abs diff {float(err.max()):.3g}, "
          f"{m.comm_bits_per_coord:.3f} bits/coord", flush=True)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    try:
        from repro_torch.core import levels as lv
        from repro_torch.core.codec import codec_for_scheme
        from repro_torch.core.schemes import QuantScheme
        from repro_torch.dist import sync
        from repro_torch.kernels import cuda, ops, ref
        from repro_torch.kernels.bucket_stats import bucket_stats_cuda
        from repro_torch.kernels.quantize import quantize_cuda
        from repro_torch.launch import train
    except ImportError as e:
        fail(f"the port is not importable from {ROOT}/src: {e}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    built = cuda.build()
    print(f"build: {json.dumps(built)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name in cuda.KERNELS:
        print(build_line(name, built.get(name), cuda.ptxas_report(name)),
              flush=True)

    kernel_grid(ops, ref, lv)
    layout_grid(ref, lv, cuda, quantize_cuda, bucket_stats_cuda)
    kernels = main_path_kernels(ops, ref, lv, cuda, codec_for_scheme,
                                QuantScheme)
    sync_check(sync, QuantScheme, codec_for_scheme)

    # ---- phase A ----
    cuda.reset_launches()
    res = train.run(train.parse_args([
        "--arch", "paper-proxy", "--workers", "4", "--scheme", "alq",
        "--bits", "3", "--bucket", "1024", "--update-at", "2,10",
        "--steps", "16", "--lr", "2e-3", "--data", "markov"]))
    counts_a = dict(cuda.LAUNCHES)
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

    # ---- phase B ----
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launches()
    res = train.run(train.parse_args([
        "--arch", "llama3.2-1b", "--layers", "4", "--workers", str(M_B),
        "--batch", str(2 * M_B), "--seq", "1024", "--data", "uniform",
        "--scheme", "alq", "--bits", "3", "--bucket", str(BS_B),
        "--optim", "adamw", "--lr", "1e-4", "--update-at", "1",
        "--steps", "5", "--time-stages"]))
    counts_b = dict(cuda.LAUNCHES)
    layouts_b = dict(cuda.LAYOUTS)
    peak = torch.cuda.max_memory_allocated()
    check(res["d"] == D_B, f"phase B d = {res['d']}, expected {D_B}")
    hist = res["history"]
    check(all(math.isfinite(h["loss"]) for h in hist),
          "phase B loss not finite")
    check(all(counts_b.get(k, 0) > 0 for k in cuda.KERNELS),
          f"phase B kernel launches {counts_b}")
    check(all(layouts_b.get(f"{k}/regs", 0) == counts_b[k]
              for k in ("quantize", "bucket_stats")),
          f"phase B bucket layouts {layouts_b}")
    for t, h in enumerate(hist):
        split = ", ".join(f"{k} {v:.1f}" for k, v in h["stage_ms"].items())
        print(f"phase B step {t}: {h['step_ms']:.1f} ms/step; stages ms: "
              f"{split}; loss {h['loss']:.4f}", flush=True)
    print(f"phase B: d={res['d']}, peak memory {peak / 2**30:.2f} GiB, "
          f"launches {counts_b}, layouts {layouts_b}", flush=True)
    print(json.dumps({"phase_b": {
        "card": smi, "d": res["d"], "peak_bytes": peak,
        "launches": counts_b, "layouts": layouts_b,
        "steps": [{"step_ms": h["step_ms"], "stage_ms": h["stage_ms"],
                   "loss": h["loss"]} for h in hist]}}), flush=True)

    for k in kernels:
        k["launches"] = counts_b.get(k["name"], 0)
        k["route"] = "cuda"
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "bound_share", "ms_spread")
    print(json.dumps({"kernels": [{key: k[key] for key in keys}
                                  for k in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

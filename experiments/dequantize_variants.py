"""Time variants of ``src/repro_torch/csrc/dequantize.cu`` on the card,
beside ATen calls that move the same bytes.

Each variant is the source with one of its choices changed by a text
substitution (the units a thread of ``dequantize_mean`` takes,
``kMeanUnits``, and the streams it loads before it adds them,
``kMeanBlock``; evict-first stores; the blocks a persistent grid puts on
an SM), built with the repo's ``nvcc`` flags into ``build/variants/``,
one ``nvcc`` each, all at once, and called through its C entry points
at 128, 256 and 512 threads a block.  Every variant's output must equal
the repo's source's bit for bit.  The yardsticks are one ATen call each
that reads and writes what a kernel does (a dtype conversion
``copy_``, a ``sum`` over the streams), not the same function.  Shapes
are phase B's (llama3.2-1b at full width, 4 layers, 4 workers, buckets
of 8192) and the simulator's buckets of 512; times are CUDA events
around ``--reps`` back-to-back calls, a median and a spread over
``--rounds`` rounds taken in turns.

    python experiments/dequantize_variants.py [--out FILE]

Prints one line a (shape, variant, threads) and, with ``--out``, writes
the records as JSON with the card's name and power limit.
"""
import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core import levels as lv  # noqa: E402
from repro_torch.kernels import cuda  # noqa: E402

HBM = 3.35e12                  # H100 SXM data sheet, bytes/s
NB, BS, M = 93_832, 8192, 4    # phase B: buckets of one stream, workers
NB512 = 1_501_221              # phase G's d in buckets of 512
STORE = "  reinterpret_cast<float4*>(out)[u] = v;"
UNITS = "constexpr int kMeanUnits = 2;"
BLOCK = "constexpr int kMeanBlock = 4;"
VARIANTS = {
    "repo": [],
    "units 1": [(UNITS, "constexpr int kMeanUnits = 1;")],
    "units 4": [(UNITS, "constexpr int kMeanUnits = 4;")],
    "units 4, block 2": [(UNITS, "constexpr int kMeanUnits = 4;"),
                         (BLOCK, "constexpr int kMeanBlock = 2;")],
    "units 2, block 2": [(BLOCK, "constexpr int kMeanBlock = 2;")],
    "evict-first stores": [
        (STORE, "  __stcs(reinterpret_cast<float4*>(out) + u, v);")],
    "4096 threads an SM": [("(2048 / threads)", "(4096 / threads)")],
}


def build(out_dir: str) -> dict:
    """Each variant's library, built in parallel; its ptxas report."""
    src = (cuda.CSRC / "dequantize.cu").read_text()
    os.makedirs(out_dir, exist_ok=True)
    for h in cuda.CSRC.glob("*.cuh"):
        with open(os.path.join(out_dir, h.name), "w") as f:
            f.write(h.read_text())
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        text = src
        for old, new in subs:
            if old not in text:
                raise ValueError(f"variant {name!r}: {old!r} not found")
            text = text.replace(old, new)
        path = os.path.join(out_dir, f"v{i}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = path[:-3] + ".so"
        procs[name] = (lib, subprocess.Popen(
            [cuda.nvcc_path(), *cuda.NVCC_FLAGS, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = {k: v["registers"] for k, v in cuda.parse_ptxas(log).items()
                if "_vec" in k}
        handle = ctypes.CDLL(os.path.abspath(lib))
        fns = []
        for kernel in ("dequantize", "dequantize_mean"):
            fn = getattr(handle, cuda.KERNELS[kernel][1])
            fn.argtypes = cuda.KERNELS[kernel][2]
            fn.restype = ctypes.c_int
            fns.append(fn)
        libs[name] = (fns, max(regs.values()))
    return libs


def timed(fn, reps: int) -> float:
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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    libs = build(os.path.join(ROOT, "build", "variants"))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    lv3 = lv.uniform_levels(3, device=dev)
    lv8 = lv.uniform_levels(8, device=dev)
    c32 = torch.randint(-7, 8, (M * NB, BS), generator=g, device=dev,
                        dtype=torch.int32)
    c8 = torch.randint(-7, 8, (M, NB, BS), generator=g, device=dev,
                       dtype=torch.int8)
    c16 = torch.randint(-255, 256, (NB, BS), generator=g, device=dev,
                        dtype=torch.int16)
    c512 = c8.view(-1)[:NB512 * 512].view(NB512, 512)
    norms = torch.rand(M * NB512, generator=g, device=dev)
    out32 = torch.empty(M * NB, BS, device=dev)
    out = torch.empty(NB, BS, device=dev)
    out512 = torch.empty(NB512, 512, device=dev)
    n = NB * BS

    def stream():
        return torch.cuda.current_stream().cuda_stream

    # shape -> (output, bytes moved, kernel call(fns, threads), yardstick)
    shapes = {
        "dequantize (375328, 8192) int32": (
            out32, M * n * 8,
            lambda f, t: f[0](c32.data_ptr(), norms.data_ptr(),
                              lv3.data_ptr(), out32.data_ptr(), M * NB, BS,
                              8, 2, t, stream()),
            lambda: out32.copy_(c32)),
        "dequantize (93832, 8192) int8": (
            out, n * 5,
            lambda f, t: f[0](c8.data_ptr(), norms.data_ptr(),
                              lv3.data_ptr(), out.data_ptr(), NB, BS, 8, 0,
                              t, stream()),
            lambda: out.copy_(c8[0])),
        "dequantize (93832, 8192) int16": (
            out, n * 6,
            lambda f, t: f[0](c16.data_ptr(), norms.data_ptr(),
                              lv8.data_ptr(), out.data_ptr(), NB, BS, 256,
                              1, t, stream()),
            lambda: out.copy_(c16)),
        "dequantize (1501221, 512) int8": (
            out512, NB512 * 512 * 5,
            lambda f, t: f[0](c512.data_ptr(), norms.data_ptr(),
                              lv3.data_ptr(), out512.data_ptr(), NB512, 512,
                              8, 0, t, stream()),
            lambda: out512.copy_(c512)),
        "dequantize_mean (4, 93832, 8192) int8": (
            out, M * n + 4 * n,
            lambda f, t: f[1](c8.data_ptr(), norms.data_ptr(),
                              lv3.data_ptr(), None, None, out.data_ptr(), M,
                              NB, BS, 8, 0, t, stream()),
            lambda: torch.sum(c8, 0, dtype=torch.float32, out=out)),
        "dequantize_mean (3, 93832, 8192) int8": (
            out, 3 * n + 4 * n,
            lambda f, t: f[1](c8.data_ptr(), norms.data_ptr(),
                              lv3.data_ptr(), None, None, out.data_ptr(), 3,
                              NB, BS, 8, 0, t, stream()),
            lambda: torch.sum(c8[:3], 0, dtype=torch.float32, out=out)),
    }
    want = {}
    for shape, (o, _, call, _) in shapes.items():
        call(libs["repo"][0], cuda.STREAM_THREADS)
        torch.cuda.synchronize()
        want[shape] = o.clone()
    times: dict = {}
    for rnd in range(args.rounds):
        for shape, (o, _, call, aten) in shapes.items():
            for name, (fns, _) in libs.items():
                for t in (128, 256, 512):
                    ms = timed(lambda: call(fns, t), args.reps)
                    if rnd == 0 and not torch.equal(o, want[shape]):
                        sys.exit(f"{name} at {t} threads: {shape} differs")
                    times.setdefault((shape, name, t), []).append(ms)
            times.setdefault((shape, "ATen yardstick", 0), []).append(
                timed(aten, args.reps))
    records = []
    for (shape, name, t), v in sorted(times.items(), key=lambda kv: (
            kv[0][0], statistics.median(kv[1]))):
        ms = statistics.median(v)
        bound = shapes[shape][1] / HBM * 1e3
        rec = dict(shape=shape, variant=name, threads=t, ms=ms,
                   spread=max(v) - min(v), bound_ms=bound,
                   share=bound / ms,
                   registers=libs[name][1] if name in libs else None)
        records.append(rec)
        print(f"{shape:40s} {name:20s} {t:4d} threads {ms:.4f} ms "
              f"(spread {rec['spread']:.4f}) {rec['share']:.1%} of bound, "
              f"registers {rec['registers']}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "records": records}, f, indent=1)


if __name__ == "__main__":
    main()

"""One run of one cell: set-up, the measured (or traced) window, the
output check, and the result line.

  python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Set-up builds the trainer from the seed and runs its first
``CHECK_STEPS`` steps through the window's own call and feed: the first
a level update (the traffic's schedule), the others steady; their
readings are kept for the check.  The window (``--trace 0``) runs steady
steps until ``--seconds`` have passed and reads the cell's end-to-end
metrics; a traced run (``--trace 1``) runs ``TRACE_STEPS`` steady steps
under the profiler instead and reads its per-layer metrics.  Then the
program is freed, the reference follows the same first steps from the
seed, and the numbers of the comparison decide ``correct``.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
import time

import torch

from . import cells, check, roofline, trace
from .faults import planted
from .system import Program, timed_steps
from reference.step import follow

CHECK_STEPS = 3
TRACE_STEPS = 2
# modules whose top-level name, compared whole, may not be loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class WindowContext:
    """What an end-to-end reader gets."""

    steps: int
    seconds: float
    setup_s: float
    peak_bytes: int
    wire_bits_per_coord: float
    m: dict
    traffic: object
    d: int
    peak: object


def parse_args(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run_cell(cell: cells.Cell, seed: int, seconds: float, traced: bool,
             device, peak, t_start: float, fault: str | None = None) -> dict:
    """The run's result (without ``device``); ``fault`` plants one of
    ``faults.FAULTS`` in the program (tests and calibration only)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    prog = Program(cell.model, cell.traffic, seed, device)
    built_s = time.perf_counter() - t_start
    with planted(fault, prog):
        got = check.program_readings(prog, CHECK_STEPS)
        _free(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start
        print(f"set-up: the trainer built at {built_s:.2f} s, its first "
              f"{CHECK_STEPS} steps done at {setup_s:.2f} s", file=sys.stderr)
        if traced:
            ctx = trace.traced_steps(prog, TRACE_STEPS, peak)
            steps, failed = TRACE_STEPS, 0
            metrics = {}
            for mt in cell.per_layer:
                v = mt.read(ctx)
                if v is not None:
                    metrics[mt.name] = {"value": v, "unit": mt.unit}
            extra = {"busy_s": ctx.busy_s, "window_s": ctx.window_s}
            brk = trace.breakdown(ctx)
        else:
            prog.transport.bytes = 0
            steps, secs, failed, ends = timed_steps(prog, seconds)
            print("window step ends, s: " + " ".join(f"{e:.4f}" for e in ends),
                  file=sys.stderr)
            ctx = WindowContext(
                steps=steps, seconds=secs, setup_s=setup_s,
                peak_bytes=torch.cuda.max_memory_allocated() if cuda else 0,
                wire_bits_per_coord=prog.transport.bits_per_coord(steps,
                                                                  prog.d),
                m=cell.model, traffic=cell.traffic, d=prog.d, peak=peak)
            metrics = {mt.name: {"value": mt.read(ctx), "unit": mt.unit}
                       for mt in cell.end_to_end}
            extra, brk = {}, None
        peak_bytes = torch.cuda.max_memory_allocated() if cuda else 0
    del prog
    _free(device)
    want = follow(cell.model, cell.traffic, seed, CHECK_STEPS, device)
    correct, table = check.judge(check.numbers(got, want), cell.limits)
    out = {"correct": correct, "attempted": steps, "failed": failed,
           "metrics": metrics, "memory_peak_bytes": peak_bytes, **extra}
    if brk is not None:
        out["breakdown"] = brk
    out["checks"] = table
    return out


def forbidden_modules() -> list[str]:
    return sorted({k.split(".")[0] for k in sys.modules}
                  & set(FORBIDDEN))


def main(argv, t_start: float) -> int:
    args = parse_args(argv)
    cell = cells.resolve(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} here", file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   roofline.peak_of(kind), t_start)
    found = forbidden_modules()
    if found:
        print(f"loaded in the result's process: {found}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": res.pop("memory_peak_bytes")}
    for k in ("busy_s", "window_s"):
        if k in res:
            device[k] = res.pop(k)
    checks = res.pop("checks")
    line = {**res, "device": device, "checks": checks}
    print(f"correct: {res['correct']}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0

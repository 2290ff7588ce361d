"""The readings the limits of a cell's output check are set from, on the
card at the cell's own size (the benchmark's runs do not run this):

  python3 perfbench/calibrate.py --workload NAME --seeds 1,2,... \
      [--control-seeds 1,2,3] [--fault-seeds 1,2,3]

For each seed: the numbers of the comparison for the sound program (the
lower reading is their largest over the seeds); on the control seeds the
same numbers for the control, the reference computed in float8 put in
the program's place; on the fault seeds for the program with each fault
of ``harness.faults`` planted (the upper reading is the least of these).
One JSON line a seed and side.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "perfbench")]

import argparse  # noqa: E402

import torch  # noqa: E402

from harness import cells, check, faults, shapes  # noqa: E402
from harness.run import CHECK_STEPS, _free  # noqa: E402
from harness.system import Program  # noqa: E402
from reference.step import follow  # noqa: E402


def _ints(s):
    return [int(x) for x in s.split(",") if x]


def program(cell, seed, device, fault=None):
    prog = Program(cell.model, cell.traffic, seed, device)
    with faults.planted(fault, prog):
        got = check.program_readings(prog, CHECK_STEPS)
    del prog
    _free(device)
    return got


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, required=True)
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = cells.resolve(args.workload)
    device = torch.device(args.device)
    seeds = list(dict.fromkeys(args.seeds + args.control_seeds
                               + args.fault_seeds))
    for seed in seeds:
        t0 = time.perf_counter()
        sides = {}
        if seed in args.seeds:
            sides["program"] = program(cell, seed, device)
        for f in faults.FAULTS if seed in args.fault_seeds else ():
            sides[f] = program(cell, seed, device, f)
        want = follow(cell.model, cell.traffic, seed, CHECK_STEPS, device)
        _free(device)
        if seed in args.control_seeds:
            sides["control"] = follow(cell.model, cell.traffic, seed,
                                      CHECK_STEPS, device, fp8=True)
            _free(device)
        names = [lf.name for lf in shapes.leaves(cell.model)]
        for side, got in sides.items():
            worst = {k: names[int(((getattr(got, k) - getattr(want, k)).abs()
                                   / getattr(want, k)).argmax())]
                     for k in ("grad1", "delta")}
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "side": side,
                              "numbers": check.numbers(got, want),
                              "worst_leaf": worst,
                              "losses": got.losses,
                              "ref_losses": want.losses}), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()

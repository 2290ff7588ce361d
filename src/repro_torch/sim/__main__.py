"""CLI: run a named scenario grid and write JSON trajectories.

    python -m repro_torch.sim --scenario paper_mlp
    python -m repro_torch.sim --scenario stragglers --steps 20 --workers 8
    python -m repro_torch.sim --scenario paper_mlp --device cpu --steps 4
    python -m repro_torch.sim --list

Runs on the CUDA device unless ``--device cpu`` is given, and refuses to
start when that device is missing.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.sim",
        description="Cluster simulator for quantized data-parallel SGD: "
                    "runs a (scheme x topology) scenario grid with M "
                    "logical workers on one device and writes per-step "
                    "JSON trajectories.")
    ap.add_argument("--scenario", default="paper_mlp",
                    help="registered scenario name (see --list)")
    ap.add_argument("--steps", type=int, default=None,
                    help="override the scenario's step count")
    ap.add_argument("--workers", type=int, default=None,
                    help="override the cluster's worker count")
    ap.add_argument("--out", default=None,
                    help="output path (default: SIM_<scenario>.json)")
    ap.add_argument("--device", default="cuda",
                    help="device the workers run on (cuda | cpu)")
    ap.add_argument("--list", action="store_true",
                    help="list registered scenarios and exit")
    args = ap.parse_args(argv)

    from repro_torch.sim import SCENARIOS, run_scenario

    if args.list:
        for name, s in sorted(SCENARIOS.items()):
            grid = f"{len(s.schemes)}x{len(s.topologies)}"
            if len(s.compress) > 1:
                grid += f"x{len(s.compress)}"
            print(f"{name:20s} [{grid} grid, {s.cluster.num_workers} "
                  f"workers, {s.steps} steps] {s.description}")
        return 0

    if args.scenario not in SCENARIOS:
        print(f"unknown scenario {args.scenario!r}; known: "
              f"{sorted(SCENARIOS)}", file=sys.stderr)
        return 2
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        raise RuntimeError("no CUDA device; pass --device cpu to simulate "
                           "on the CPU")

    t0 = time.perf_counter()
    result = run_scenario(SCENARIOS[args.scenario], steps=args.steps,
                          workers=args.workers, device=args.device)
    result["wallclock_s"] = round(time.perf_counter() - t0, 3)

    out_path = args.out or f"SIM_{args.scenario}.json"
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    ncells = len(result["cells"])
    print(f"wrote {out_path}: {ncells} cells x "
          f"{result['num_steps']} steps in {result['wallclock_s']}s")
    for c in result["cells"]:
        t = c["totals"]
        print(f"  {c['scheme']:10s} {c['topology']:12s} "
              f"final_loss={t['final_loss']:.4f} "
              f"sim_time={t['sim_time_ms']:.1f}ms "
              f"wire={t['wire_bytes']:.3e}B "
              f"agg_err={t['mean_agg_err']:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Phase B's steps and phase O's stacked FSDP run for several checkouts in
one call on the card, each in a process of its own, in the order given
(say parent, change, change, parent), so that the host's drift shows as
the spread between a tree's two runs.

    python experiments/division_ab.py --tree parent=<parent checkout> \\
        --tree change=. --order parent,change,change,parent

A checkout is a directory with ``src/repro_torch`` and ``chip_smoke.py``.
Phase B: llama3.2-1b at full width, 4 of 16 layers, 4 stacked workers of
2 x 1024 uniform tokens, ALQ 3-bit, buckets of 8192, AdamW, a level update
at step 1, 5 steps through the launcher (``chip_smoke.py``'s argv).  Phase
O: ``chip_smoke.py --fsdp-run OUT quantized``, qwen3-0.6b whole in FSDP,
2 stacked workers, 3 steps.  Prints one JSON object: the card's name and
power limit, and per run the steps' ms, their stages and the launches.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

PHASE_B = ["--arch", "llama3.2-1b", "--layers", "4", "--workers", "4",
           "--batch", "8", "--seq", "1024", "--data", "uniform",
           "--scheme", "alq", "--bits", "3", "--bucket", "8192",
           "--optim", "adamw", "--lr", "1e-4", "--update-at", "1",
           "--time-stages", "--steps", "5"]

B_CODE = """
import json, sys
from repro_torch.kernels import cuda
from repro_torch.launch import train
cuda.build()
cuda.reset_launches()
res = train.run(train.parse_args(sys.argv[1:]))
print("RESULT " + json.dumps({
    "steps": [{"step_ms": h["step_ms"], "stage_ms": h["stage_ms"]}
              for h in res["history"]],
    "launches": dict(cuda.LAUNCHES)}))
"""


def run_b(tree: str) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(tree, "src"),
               OMP_NUM_THREADS="1")
    sub = subprocess.run([sys.executable, "-c", B_CODE, *PHASE_B], cwd=tree,
                         env=env, capture_output=True, text=True)
    if sub.returncode:
        raise RuntimeError(f"phase B in {tree}: {sub.stderr[-3000:]}")
    line = [x for x in sub.stdout.splitlines() if x.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


def run_o(tree: str) -> dict:
    with tempfile.TemporaryDirectory(dir=os.path.join(tree, "build")) as out:
        env = dict(os.environ, OMP_NUM_THREADS="1")
        sub = subprocess.run(
            [sys.executable, os.path.join(tree, "chip_smoke.py"),
             "--fsdp-run", out, "quantized"], cwd=tree, env=env,
            capture_output=True, text=True)
        if sub.returncode:
            raise RuntimeError(f"phase O in {tree}: {sub.stdout[-2000:]}"
                               f"{sub.stderr[-3000:]}")
        with open(os.path.join(out, "rankstacked.json")) as f:
            rec = json.load(f)
    return {k: rec[k] for k in ("step_ms", "stage_ms", "launches", "loss")}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", required=True,
                    help="LABEL=DIR, a checkout")
    ap.add_argument("--order", required=True,
                    help="labels, comma-separated, in the order to run")
    args = ap.parse_args()
    trees = dict(t.split("=", 1) for t in args.tree)
    for tree in trees.values():
        os.makedirs(os.path.join(tree, "build"), exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    runs = []
    for label in args.order.split(","):
        tree = os.path.abspath(trees[label])
        rec = {"tree": label, "B": run_b(tree), "O": run_o(tree)}
        steady = [s["step_ms"] for s in rec["B"]["steps"][2:]]
        rs = [st.get("reduce_scatter") for st in rec["O"]["stage_ms"]]
        print(f"{label}: phase B steps 2-4 ms {steady}, phase O "
              f"reduce_scatter ms {rs}, O launches {rec['O']['launches']}",
              file=sys.stderr, flush=True)
        runs.append(rec)
    print(json.dumps({"card": card, "runs": runs}))


if __name__ == "__main__":
    main()

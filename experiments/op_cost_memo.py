"""Time the dry run's count of one step with ``CostMode``'s own memo of
output metadata, with no memo, and with no memo under torch's
``FakeTensorMode`` (whose dispatch cache skips the meta kernels on a
hit), and print each run's seconds beside its counts, which must agree.

Usage (on the CPU, no card needed):
    PYTHONPATH=src python experiments/op_cost_memo.py [--arch llama3.2-1b]
        [--shape train_4k]
"""
import argparse
import contextlib
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import dryrun, op_cost
from repro_torch.launch.mesh import make_production_mesh


@contextlib.contextmanager
def variant(name: str):
    """``memo``: CostMode as it is; ``none``: every operator runs its meta
    kernel; ``fake``: as ``none``, under FakeTensorMode."""
    run, rule = op_cost.CostMode._run, op_cost.CostMode._rule

    def plain_run(self, func, args, kwargs):
        return func(*args, **kwargs)

    def prim_rule(self, func):
        # FakeTensorMode issues prim::device, which has no dispatch keys
        if func.namespace == "prim":
            self._rules[func] = (False, None, None, False)
            return self._rules[func]
        return rule(self, func)

    ctx = contextlib.nullcontext()
    if name != "memo":
        op_cost.CostMode._run = plain_run
    if name == "fake":
        from torch._subclasses.fake_tensor import FakeTensorMode
        op_cost.CostMode._rule = prim_rule
        ctx = FakeTensorMode(allow_non_fake_inputs=True)
    try:
        with ctx:
            yield
    finally:
        op_cost.CostMode._run, op_cost.CostMode._rule = run, rule


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--shape", default="train_4k")
    args = ap.parse_args()
    torch.set_num_threads(1)
    cfg, shape = get_config(args.arch), SHAPES[args.shape]
    mesh = make_production_mesh()
    for name in ("memo", "none", "fake", "memo"):
        t0 = time.perf_counter()
        with variant(name):
            cost, info = dryrun.dry_pair(cfg, shape, mesh)
        print(f"{name}: {time.perf_counter() - t0:.1f} s; flops "
              f"{cost.flops:.6e}, matmul {cost.matmul_flops:.6e}, hbm "
              f"{cost.hbm_bytes:.6e}, wire {cost.collective_bytes:.6e}, "
              f"peak {cost.peak_bytes}", flush=True)


if __name__ == "__main__":
    main()

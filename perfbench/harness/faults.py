"""Faults planted in the program's timed path, for the tests and the
calibration that show the comparison catches them.  A normal run plants
none.

- ``unchanged``: the optimizer returns its state unchanged, so no step
  moves the parameters;
- ``half_batch``: the aggregate is the mean over the first half of the
  workers, the rest of the batch left out;
- ``no_exchange``: the workers exchange nothing, and the aggregate is
  worker 0's own gradient.
"""
from __future__ import annotations

import contextlib

from repro_torch.kernels import ops
from repro_torch.train import train_step as train_step_mod

FAULTS = ("unchanged", "half_batch", "no_exchange")


@contextlib.contextmanager
def planted(fault: str | None, prog):
    if fault is None:
        yield
        return
    if fault not in FAULTS:
        raise ValueError(f"fault {fault!r}; known: {FAULTS}")
    keep = prog.tr.workers // 2 if fault == "half_batch" else 1
    saved = []

    def patch(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    if fault == "unchanged":
        patch(train_step_mod, "apply_updates",
              lambda cfg, flat, grad, state:
              state._replace(count=state.count + 1))
    else:
        mean = ops.dequantize_mean_op

        def kept(codes, norms, levels, weights=None, valid=None):
            if weights is not None:     # the kept workers' weights, renormed
                weights = weights[:keep] / weights[:keep].sum(0)
            return mean(codes[:keep], norms[:keep], levels, weights,
                        None if valid is None else valid[:keep])

        patch(ops, "dequantize_mean_op", kept)
        psum = prog.transport.mean_psum
        patch(prog.transport, "mean_psum",
              lambda stacked: psum(stacked[:keep]))
    try:
        yield
    finally:
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)

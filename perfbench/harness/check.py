"""The comparison that decides ``correct``: the program's readings of its
first steps against the reference's of the same seed.

- ``loss``: the largest gap of a step's loss (the mean over workers),
  over the reference's loss.
- ``grad1``: the first aggregate the optimizer got, by the worst leaf:
  the gap between the program's norm of that leaf and the reference's,
  over the reference's norm of that leaf or of the median leaf, whichever
  is larger.  The program's is worked out from its AdamW state after one
  step (the first moment over 1 - b1).
- ``delta``: the parameters' change over the steps, by the worst leaf,
  measured alike.
- ``levels``: the largest gap of a level after the first step's update.
- ``grad1_median``, ``delta_median``: the median leaf's gap of each,
  steadier from seed to seed than the worst leaf's.

Leaves whose first aggregate the reference finds under a thousandth of
the median leaf's are nought to rounding, move under AdamW by round-off
alone, and are left out of ``grad1`` and ``delta``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from reference.step import Readings, leaf_norms
from . import shapes

NEGLIGIBLE = 1e-3


def program_readings(prog, steps: int) -> Readings:
    """Run the program's first ``steps`` steps and read them."""
    opt = prog.tr.optimizer
    if opt["name"] != "adamw":
        raise ValueError("the check reads AdamW's first moment")
    leaves = shapes.leaves(prog.m)
    flat0 = prog.model.flat.detach().clone()
    losses, grad1, levels = [], None, None
    for t in range(steps):
        losses.append(prog.train_step()["loss"])
        if t == 0:
            one_minus_b1 = float(np.float32(1 - opt.get("b1", 0.9)))
            grad1 = leaf_norms(prog.trainer.opt.mu, leaves) / one_minus_b1
            if prog.tr.quantized:
                levels = prog.trainer.scheme_state.levels.cpu()
    delta = leaf_norms(prog.model.flat.detach() - flat0, leaves)
    return Readings(losses, grad1, delta, levels)


def _leaf_gaps(got: torch.Tensor, want: torch.Tensor, keep
               ) -> torch.Tensor:
    scale = torch.clamp(want[keep], min=float(want[keep].median()))
    return (got[keep] - want[keep]).abs() / scale


def numbers(got: Readings, want: Readings) -> dict[str, float]:
    keep = want.grad1 >= NEGLIGIBLE * float(want.grad1.median())
    gaps = [abs(a - b) / abs(b) for a, b in zip(got.losses, want.losses)]
    g1 = _leaf_gaps(got.grad1, want.grad1, keep)
    dl = _leaf_gaps(got.delta, want.delta, keep)
    out = {"loss": math.nan if any(map(math.isnan, gaps)) else max(gaps),
           "grad1": float(g1.max()), "delta": float(dl.max()),
           "grad1_median": float(g1.median()),
           "delta_median": float(dl.median())}
    if want.levels is not None:
        out["levels"] = float((got.levels - want.levels).abs().max())
    return out


def judge(values: dict[str, float], limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {value, limit}}): correct iff every number with
    a limit is finite and within it."""
    table, ok = {}, True
    for name, v in values.items():
        lim = limits.get(name)
        table[name] = {"value": v, "limit": lim}
        if lim is not None and not (math.isfinite(v) and v <= lim):
            ok = False
    missing = [k for k, v in limits.items() if v is not None
               and k not in values]
    if missing:
        raise ValueError(f"limits for numbers not compared: {missing}")
    return ok, table

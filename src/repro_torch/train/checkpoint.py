"""Checkpoints of named tensors (npz files).

Crash-safe by construction: ``save`` writes a sibling tmp file, fsyncs
it, then ``os.replace``s it into place, so a reader never sees a torn
checkpoint and a crash mid-save leaves the previous one intact.
``save_step`` / ``latest_checkpoint`` / ``restore_latest`` lay a
step-numbered directory convention on top, which the launcher's periodic
save and auto-resume use (``repro_torch.launch.train``).

A checkpoint is a flat ``{name: tensor}`` dictionary, as
``Trainer.state_arrays`` gives it; ``restore`` loads one into the names,
shapes, dtypes and devices of a dictionary like it.
"""
from __future__ import annotations

import os
import re
import time

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d+)\.npz$")


def save(path: str, arrays: dict[str, torch.Tensor]) -> None:
    flat = {}
    for name, t in arrays.items():
        t = torch.as_tensor(t).detach().cpu()
        if t.dtype == torch.bfloat16:   # npz has no bf16
            t = t.float()
        flat[name] = t.numpy()
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())  # durable before the rename commits it
    os.replace(tmp, path)


def save_with_retry(path: str, arrays: dict[str, torch.Tensor], *,
                    attempts: int = 3, backoff_s: float = 0.1) -> None:
    """``save`` with bounded retry and backoff on OSError (full disk,
    NFS hiccup, ...).  Re-raises the last error after ``attempts``."""
    for i in range(attempts):
        try:
            save(path, arrays)
            return
        except OSError:
            if i == attempts - 1:
                raise
            time.sleep(backoff_s * (2 ** i))


def restore(path: str, like: dict[str, torch.Tensor]
            ) -> dict[str, torch.Tensor]:
    """Load ``path`` into the names, shapes, dtypes and devices of
    ``like``.

    Raises ValueError naming the missing and extra names on a structure
    mismatch, and the offending name on a shape mismatch.
    """
    with np.load(path) as data:
        want, have = set(like), set(data.files)
        if want != have:
            raise ValueError(
                f"checkpoint {path!r} does not match the expected "
                f"structure: missing keys {sorted(want - have) or 'none'}, "
                f"extra keys {sorted(have - want) or 'none'} (saved with a "
                "different model/optimizer config?)")
        out = {}
        for name, ref in like.items():
            ref = torch.as_tensor(ref)
            arr = data[name]
            if arr.shape != tuple(ref.shape):
                raise ValueError(f"checkpoint mismatch at {name}: "
                                 f"{arr.shape} vs {tuple(ref.shape)}")
            out[name] = torch.from_numpy(arr).to(dtype=ref.dtype,
                                                 device=ref.device)
    return out


# ---------------------------------------------------------------------------
# step-numbered checkpoint directories (periodic save + auto-resume)
# ---------------------------------------------------------------------------

def step_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}.npz")


def save_step(ckpt_dir: str, step: int, arrays: dict[str, torch.Tensor], *,
              keep: int = 3) -> str:
    """Save ``arrays`` as ``ckpt_dir/step_NNNNNNNN.npz`` (with retry),
    pruning all but the newest ``keep`` checkpoints.  Returns the path."""
    path = step_path(ckpt_dir, step)
    save_with_retry(path, arrays)
    steps = list_checkpoints(ckpt_dir)
    for old in steps[:-keep] if keep > 0 else []:
        try:
            os.remove(step_path(ckpt_dir, old))
        except OSError:
            pass  # pruning is best-effort; never fail the save
    return path


def list_checkpoints(ckpt_dir: str) -> list[int]:
    """Step numbers of the checkpoints in ``ckpt_dir``, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for name in os.listdir(ckpt_dir)
                  if (m := _STEP_RE.match(name)))


def latest_checkpoint(ckpt_dir: str) -> tuple[int, str] | None:
    """(step, path) of the newest checkpoint, or None if there is none."""
    steps = list_checkpoints(ckpt_dir)
    if not steps:
        return None
    return steps[-1], step_path(ckpt_dir, steps[-1])


def restore_latest(ckpt_dir: str, like: dict[str, torch.Tensor]
                   ) -> tuple[int, dict[str, torch.Tensor]] | None:
    """Restore the newest checkpoint in ``ckpt_dir`` into the structure
    of ``like``: (step, arrays), or None when there is none (a fresh
    start)."""
    found = latest_checkpoint(ckpt_dir)
    if found is None:
        return None
    step, path = found
    return step, restore(path, like)

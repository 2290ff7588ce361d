"""The layer kinds the benchmark knows, one file each, found here when
this package is imported: adding a kind adds a file, and no other file
changes.

A layer slot is pre-norm: ``norm1``, a mixer, ``norm2``, an FFN (the
stack's, ``harness/shapes.py``).  A kind is the mixer or the FFN of the
slots it takes, and its file states:

- ``ROLE``: ``"mixer"`` or ``"ffn"``;
- ``KEYS``: the configuration's ``model`` keys it reads;
- ``takes(m, slot)``: whether it is the ``ROLE`` of layer slot ``slot``
  (within a group) of the configuration numbers ``m``.  ``DEFAULT =
  True`` makes a kind take only the slots that no other kind of its
  role takes;
- ``period(m)`` (optional): the length of the pattern its slots repeat
  in; the stack's group is the lcm of every kind's period;
- ``leaves(m, slot)``: its leaves, path within the role -> (per-layer
  shape, draw, fan_in), named as the port's ``slot_layout`` names them;
- ``active(m, slot)``: the parameters a token touches, for model FLOPs;
- ``DRAWS`` (optional): draw name -> ``fill(view, gen, fan_in)`` for
  each draw of its own beyond ``normal`` (times fan_in ** -0.5), ``ones``
  and ``zeros``;
- ``forward(ref, p, x, slot)``: its equations in plain PyTorch, ``p``
  its leaves in the compute dtype, ``ref`` the ``reference.model
  .Reference`` whose helpers (``mm``, ``rms``, ``rope``) it uses;
- ``attention_shape(m, slot)`` (optional): (heads, head_dim, window)
  where the slot runs the port's attention kernels, a window of 0 being
  the whole causal prefix.

A kind is on the reference's side: it imports nothing of the port.
"""
from __future__ import annotations

import importlib
from pathlib import Path

ROLES = ("mixer", "ffn")
BASE_DRAWS = ("normal", "ones", "zeros")
_REQUIRED = ("ROLE", "KEYS", "takes", "leaves", "active", "forward")


def _discover() -> list:
    kinds = []
    for path in sorted(Path(__file__).parent.glob("*.py")):
        if path.stem == "__init__":
            continue
        kind = importlib.import_module(f"{__name__}.{path.stem}")
        missing = [a for a in _REQUIRED if not hasattr(kind, a)]
        if missing or kind.ROLE not in ROLES:
            raise ValueError(f"layers/{path.name}: a layer kind needs "
                             f"{_REQUIRED} and a ROLE in {ROLES}; "
                             f"missing {missing}")
        kinds.append(kind)
    return kinds


def _draws(kinds) -> dict:
    out = {}
    for kind in kinds:
        for name, fill in getattr(kind, "DRAWS", {}).items():
            if name in BASE_DRAWS or name in out:
                raise ValueError(f"{kind.__name__}: draw {name!r} is "
                                 "named twice")
            out[name] = fill
    return out


KINDS = _discover()
DRAWS = _draws(KINDS)


def name(kind) -> str:
    return kind.__name__.rpartition(".")[2]

"""The SwiGLU FFN, w2(silu(x w1) * (x w3)): the FFN of every slot that
no other FFN kind takes."""
from __future__ import annotations

import torch.nn.functional as F

ROLE = "ffn"
KEYS = ("d_ff",)
DEFAULT = True


def takes(m: dict, slot: int) -> bool:
    return True


def leaves(m: dict, slot: int) -> dict:
    d, ff = m["d_model"], m["d_ff"]
    return {"w1": ((d, ff), "normal", d), "w2": ((ff, d), "normal", ff),
            "w3": ((d, ff), "normal", d)}


def active(m: dict, slot: int) -> int:
    return 3 * m["d_model"] * m["d_ff"]


def forward(ref, p, h, slot: int):
    return ref.mm(F.silu(ref.mm(h, p["w1"])) * ref.mm(h, p["w3"]), p["w2"])

"""Sliding-window attention (``attn_kind: "sliding"``): attention's
equations and leaves, a query at position t seeing the keys t - window <
s <= t, as the port's masks do; with ``full_attn_every`` k, slot k - 1
of every group of k sees the whole causal prefix (the port's
``slot_attn_kind``).
"""
from __future__ import annotations

from layers import attention

ROLE = "mixer"
KEYS = attention.KEYS + ("window", "full_attn_every")
WINDOW = 4096           # the port's default window


def takes(m: dict, slot: int) -> bool:
    return (m.get("layer_pattern", "attn") == "attn"
            and m.get("attn_kind") == "sliding")


def period(m: dict) -> int:
    return m.get("full_attn_every") or 1


def window_of(m: dict, slot: int) -> int:
    """The slot's window, 0 on a full slot."""
    k = m.get("full_attn_every") or 0
    return 0 if k and slot % k == k - 1 else m.get("window", WINDOW)


leaves = attention.leaves
active = attention.active


def attention_shape(m: dict, slot: int) -> tuple[int, int, int]:
    heads, hd, _ = attention.attention_shape(m, slot)
    return heads, hd, window_of(m, slot)


def forward(ref, p, x, slot: int):
    return attention.attend(ref, p, x, window_of(ref.m, slot))

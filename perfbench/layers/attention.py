"""Attention: GQA with RoPE over the whole causal prefix, with optional
qk-norm (Qwen3), as the mixer of every slot of a plain attention stack.

The scores and the softmax are float32, one plain softmax over the
masked scores, where the port runs a blockwise loop.  ``attend`` takes
a window, which ``window.py`` gives.
"""
from __future__ import annotations

import torch

ROLE = "mixer"
KEYS = ("layer_pattern", "attn_kind", "head_dim", "qk_norm", "rope_theta")


def takes(m: dict, slot: int) -> bool:
    return (m.get("layer_pattern", "attn") == "attn"
            and m.get("attn_kind", "full") == "full"
            and not m.get("full_attn_every"))


def head_dim(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["num_heads"]


def leaves(m: dict, slot: int) -> dict:
    d, hd = m["d_model"], head_dim(m)
    nq, nkv = m["num_heads"] * hd, m["num_kv_heads"] * hd
    out = {"wq": ((d, nq), "normal", d), "wk": ((d, nkv), "normal", d),
           "wv": ((d, nkv), "normal", d), "wo": ((nq, d), "normal", nq)}
    if m.get("qk_norm"):
        out["q_norm"] = ((hd,), "ones", 0)
        out["k_norm"] = ((hd,), "ones", 0)
    return out


def active(m: dict, slot: int) -> int:
    """The four projections."""
    d, hd = m["d_model"], head_dim(m)
    nq, nkv = m["num_heads"] * hd, m["num_kv_heads"] * hd
    return d * nq + 2 * d * nkv + nq * d


def attention_shape(m: dict, slot: int) -> tuple[int, int, int]:
    return m["num_heads"], head_dim(m), 0


def attend(ref, p, x, window: int = 0):
    """x (B, S, d) -> (B, S, d): query t sees the keys t - window < s <= t
    (every s <= t where ``window`` is 0)."""
    m = ref.m
    B, S, _ = x.shape
    hd = head_dim(m)
    H, KV = m["num_heads"], m["num_kv_heads"]
    q = ref.mm(x, p["wq"]).reshape(B, S, H, hd)
    k = ref.mm(x, p["wk"]).reshape(B, S, KV, hd)
    v = ref.mm(x, p["wv"]).reshape(B, S, KV, hd)
    if "q_norm" in p:
        q = ref.rms(q, p["q_norm"])
        k = ref.rms(k, p["k_norm"])
    q, k = ref.rope(q), ref.rope(k)
    # kv head j serves the H // KV consecutive q heads from j * H // KV
    k = k.repeat_interleave(H // KV, dim=2)
    v = v.repeat_interleave(H // KV, dim=2)
    qt = q.transpose(1, 2).float() * hd ** -0.5
    s = qt @ k.transpose(1, 2).float().transpose(-1, -2)
    seen = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    if window > 0:
        seen = seen.triu(1 - window)
    a = torch.softmax(s.masked_fill(~seen, float("-inf")), -1)
    o = (a @ v.transpose(1, 2).float()).transpose(1, 2).to(x.dtype)
    return ref.mm(o.reshape(B, S, H * hd), p["wo"])


def forward(ref, p, x, slot: int):
    return attend(ref, p, x)

"""What the benchmark works out from a configuration's numbers alone: the
parameter leaves in the order of the flat vector that the trainer
updates, how each leaf is drawn, the coordinate count d, the parameter
counts that model FLOPs are taken from, and the wire's bucket layout.

The flat order is the reference package's ``ravel_pytree`` order, which
the port keeps: ``embed`` (1, V, d), ``final_norm`` (d,), ``lm_head``
(1, d, V), then each layer slot's leaves with their keys sorted, every
leaf stacked over the layer groups as (groups, 1, ...).  Only the layer
kinds of the benchmark's configurations are known here (attention with
a SwiGLU FFN, RWKV6's time-mix with a SwiGLU FFN); a configuration of
another kind is refused.
"""
from __future__ import annotations

import math
from typing import NamedTuple

# how a leaf is drawn: normal * fan_in ** -0.5, ones, zeros, or one of
# the trained-like draws of RWKV6's time-mix (``weights.py``)
NORMAL, ONES, ZEROS = "normal", "ones", "zeros"
MIX, DECAY_BASE, DECAY_LORA_B = "mix", "decay_base", "decay_lora_b"

RWKV_LORA = 64
BUCKET_TILE = 8     # the wire pads its bucket count to a multiple of this


class Leaf(NamedTuple):
    name: str
    shape: tuple
    offset: int
    draw: str
    fan_in: int = 0

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


def head_dim(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["num_heads"]


def _slot_leaves(m: dict) -> dict[str, tuple[tuple, str, int]]:
    """A layer's leaves: path -> (shape, draw, fan_in)."""
    d, ff = m["d_model"], m["d_ff"]
    leaves = {"norm1": ((d,), ONES, 0), "norm2": ((d,), ONES, 0),
              "ffn.w1": ((d, ff), NORMAL, d), "ffn.w2": ((ff, d), NORMAL, ff),
              "ffn.w3": ((d, ff), NORMAL, d)}
    pattern = m.get("layer_pattern", "attn")
    if m.get("moe") or m.get("cross_attn_every") or pattern not in (
            "attn", "rwkv") or m.get("qkv_bias"):
        raise ValueError(f"{m['name']}: only dense attention and RWKV6 "
                         "layers are laid out by the benchmark")
    if pattern == "rwkv":
        hd = m.get("rwkv_head_dim", 64)
        dl = (d // hd) * hd
        for k in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w"):
            leaves[f"mixer.{k}"] = ((d,), MIX, 0)
        leaves.update({
            "mixer.w0": ((d,), DECAY_BASE, 0),
            "mixer.w_lora_a": ((d, RWKV_LORA), NORMAL, d),
            "mixer.w_lora_b": ((RWKV_LORA, d), DECAY_LORA_B, RWKV_LORA),
            "mixer.proj_r": ((d, dl), NORMAL, d),
            "mixer.proj_k": ((d, dl), NORMAL, d),
            "mixer.proj_v": ((d, dl), NORMAL, d),
            "mixer.proj_g": ((d, dl), NORMAL, d),
            "mixer.u": ((dl,), ZEROS, 0),
            "mixer.ln_x": ((dl,), ONES, 0),
            "mixer.wo": ((dl, d), NORMAL, d)})
        return leaves
    hd = head_dim(m)
    nq, nkv = m["num_heads"] * hd, m["num_kv_heads"] * hd
    leaves.update({"mixer.wq": ((d, nq), NORMAL, d),
                   "mixer.wk": ((d, nkv), NORMAL, d),
                   "mixer.wv": ((d, nkv), NORMAL, d),
                   "mixer.wo": ((nq, d), NORMAL, nq)})
    if m.get("qk_norm"):
        leaves["mixer.q_norm"] = ((hd,), ONES, 0)
        leaves["mixer.k_norm"] = ((hd,), ONES, 0)
    return leaves


def leaves(m: dict) -> list[Leaf]:
    """Every parameter leaf of the configuration ``m`` (the numbers of
    its ``model`` entry), in flat order, with its offset."""
    d, V, L = m["d_model"], m["vocab_size"], m["num_layers"]
    top = [("embed", (1, V, d), NORMAL, d), ("final_norm", (d,), ONES, 0),
           ("lm_head", (1, d, V), NORMAL, d)]
    slot = _slot_leaves(m)
    top += [(f"slots.0.{p}", (L, 1, *slot[p][0]), *slot[p][1:])
            for p in sorted(slot, key=lambda p: p.split("."))]
    out, off = [], 0
    for name, shape, draw, fan_in in top:
        leaf = Leaf(name, shape, off, draw, fan_in)
        out.append(leaf)
        off += leaf.numel
    return out


def coordinates(m: dict) -> int:
    """d: the length of the flat parameter vector, and of a gradient."""
    last = leaves(m)[-1]
    return last.offset + last.numel


def param_count(m: dict) -> int:
    """Parameters as the dry run counts them for model FLOPs: the
    embedding and the head, and per layer the mixer (attention's four
    projections; RWKV6's time-mix as 6 d^2) and the SwiGLU FFN (3 d d_ff),
    without norms, biases or the decay LoRA."""
    d, ff, V = m["d_model"], m["d_ff"], m["vocab_size"]
    if m.get("layer_pattern", "attn") == "rwkv":
        mix = 6 * d * d
    else:
        hd = head_dim(m)
        nq, nkv = m["num_heads"] * hd, m["num_kv_heads"] * hd
        mix = d * nq + 2 * d * nkv + nq * d
    return 2 * V * d + m["num_layers"] * (mix + 3 * d * ff)


def model_flops(m: dict, tokens: int) -> float:
    """Training's model FLOPs, 6 N D (dense: every parameter is active)."""
    return 6.0 * param_count(m) * tokens


def wire_buckets(d: int, bucket_size: int, shards: int = 1) -> int:
    """The bucket count a worker's payload is laid out in: d's buckets,
    padded to a multiple of ``BUCKET_TILE`` times the shards."""
    nb = -(-d // bucket_size)
    m = BUCKET_TILE * shards
    return -(-nb // m) * m

"""The mixture-of-experts FFN (``moe: true``): a router over all
``num_experts`` experts, top-``top_k`` routing with a capacity, and
SwiGLU experts, of which this card holds the first ``experts_held``
(all where 0): the card's share of a layer that expert parallelism
splits over ``num_experts // experts_held`` cards.

The equations, for the (T, d) tokens of one call (a worker's rows):

- the router's logits ``x router`` in the compute dtype, a float32
  softmax over all E;
- each token's top_k experts, the lower index first among equal
  probabilities, and its gates, their probabilities over their sum
  (for top_k > 1);
- the capacity C = ceil(T top_k / E x capacity_factor), rounded up to a
  multiple of 8 (at least 8), reckoned over all E;
- an expert's pairs taken in token-major order, the first C kept and
  the rest dropped;
- for each held expert, its kept tokens gathered, its SwiGLU, times each
  pair's gate, added back into the token's float32 output.

Pairs routed to an expert that another card holds add nothing: the
partial sum is what goes on to the next layer, in the program and here
alike.

Departures from the published models (Mellum2's config): the routing
keeps a capacity and drops the pairs past it, as the port does, where
the published model routes without drops; no load-balancing loss (the
stack has no place for an FFN's loss term, so a configuration must set
``router_aux_coef`` to 0, and one without it, whose port default is
0.01, is refused); no shared expert, and an MoE on every layer
(``moe_every`` 1): both others refused.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

ROLE = "ffn"
KEYS = ("d_ff", "moe", "num_experts", "experts_held", "top_k",
        "capacity_factor", "router_aux_coef", "moe_every", "shared_expert")


def _refuse_what_is_not_here(m: dict) -> None:
    E, held = m["num_experts"], m.get("experts_held", 0)
    if m.get("router_aux_coef", 0.01) != 0:
        raise ValueError(f"{m['name']}: the reference has no load-balancing "
                         "loss; router_aux_coef must be 0")
    if m.get("shared_expert") or m.get("moe_every", 1) != 1:
        raise ValueError(f"{m['name']}: a shared expert, or dense FFN "
                         "slots between MoE ones, are not here")
    if held < 0 or held > E or (held and E % held):
        raise ValueError(f"{m['name']}: {held} experts held of {E}")


def takes(m: dict, slot: int) -> bool:
    if not m.get("moe"):
        return False
    _refuse_what_is_not_here(m)
    return True


def held(m: dict) -> int:
    return m.get("experts_held") or m["num_experts"]


def leaves(m: dict, slot: int) -> dict:
    d, ff, E, El = m["d_model"], m["d_ff"], m["num_experts"], held(m)
    return {"router": ((d, E), "normal", d),
            "w1": ((El, d, ff), "normal", d),
            "w2": ((El, ff, d), "normal", ff),
            "w3": ((El, d, ff), "normal", d)}


def active(m: dict, slot: int) -> int:
    """The router and the share of a token's top_k experts that this card
    holds on average, top_k * experts_held / num_experts."""
    d, ff, E = m["d_model"], m["d_ff"], m["num_experts"]
    return d * E + m.get("top_k", 2) * held(m) * 3 * d * ff // E


def capacity(m: dict, tokens: int) -> int:
    c = int(math.ceil(tokens * m.get("top_k", 2) / m["num_experts"]
                      * m.get("capacity_factor", 1.25)))
    return max(8, -(-c // 8) * 8)


def route(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(T, E) float32 probabilities -> (gates (T, k), experts (T, k))."""
    expert = torch.argsort(probs.detach(), dim=-1, descending=True,
                           stable=True)[:, :k]
    gate = torch.gather(probs, 1, expert)
    if k > 1:
        gate = gate / gate.sum(-1, keepdim=True)
    return gate, expert


def forward(ref, p, h, slot: int):
    m = ref.m
    B, S, d = h.shape
    k = m.get("top_k", 2)
    x = h.reshape(B * S, d)
    probs = torch.softmax(ref.mm(x, p["router"]).float(), -1)
    gate, expert = route(probs, k)
    C = capacity(m, B * S)
    pair_expert, pair_gate = expert.reshape(-1), gate.reshape(-1)
    y = torch.zeros(B * S, d, dtype=torch.float32, device=h.device)
    for e in range(held(m)):
        kept = (pair_expert == e).nonzero()[:C, 0]     # token-major order
        if not len(kept):       # no pair reached it: it adds nothing
            continue
        tok = kept // k
        xe = x[tok]
        out = ref.mm(F.silu(ref.mm(xe, p["w1"][e])) * ref.mm(xe, p["w3"][e]),
                     p["w2"][e])
        # a token meets an expert at most once: each row added once a call
        y = y.index_add(0, tok, out.float() * pair_gate[kept, None])
    return y.reshape(B, S, d)

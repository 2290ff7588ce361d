"""Mixture-of-experts FFN with capacity-based top-k routing.

The reference computes it in plain jnp (``moe_ffn``), and so does the
port, with the same numerics: router logits from the compute-dtype
matmul, cast to float32; softmax and top-k (the lower expert index first
among equal probabilities, as ``jax.lax.top_k`` orders them), gates
renormalised only for k > 1; the Switch aux loss; each (token, slot)
pair ranked within its expert by a cumulative sum in token-major order,
and pairs ranked at or past the capacity C dropped.  The experts run as
batched SwiGLU products over (E, C, d).

No step adds into a shared location.  The dispatch is an index
assignment of the kept pairs (each (expert, position) holds at most one
token; dropped pairs go to a spare row that is cut off), and the combine
gathers each pair's output and sums a token's k slots ((T, k, d) ->
(T, d)).  These are the values of the reference's scatter-adds, and two
backward passes on the card give the same bits.

At tp > 1 the model group is factored as tp = ep * fp, ep = gcd(E, tp)
(``moe_factor``): rank r holds expert block r // fp (E / ep experts) and
FFN shard r % fp of each (``ceil(d_ff / fp)`` columns, a ceiling, not a
padded global width).  Routing is replicated (the router is a replicated
leaf), each rank runs only the pairs routed to its block, and one psum
over the group adds the expert blocks and the FFN shards together, with
the shared expert's row-parallel partial sum.

With ``cfg.experts_held`` (expert parallelism over num_experts //
experts_held cards, of which this is the first) the same blocks split
the experts at tp = 1: the card holds block 0, routes over every expert,
reckons the capacity over all of them, and runs only the pairs routed
to its block; the other pairs add nothing, and there is no collective.

While a step is being recorded (``repro_torch.timing``) the layer is a
``moe`` device span holding ``route``, ``dispatch``, ``experts`` and
``combine``, and ``moe`` counts, as device values that the recorder
resolves later, the ``pairs`` kept on this card's experts, those
``dropped`` past the capacity, those routed ``elsewhere`` (to experts
another card holds) and the ``max_load``, the most pairs routed to one
held expert.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import timing
from .config import ModelConfig
from .layers import TP1, TPCtx


def moe_factor(cfg: ModelConfig, tp: int) -> tuple[int, int]:
    """(ep, fp): expert blocks and FFN shards of a group of tp ranks; with
    ``experts_held``, the blocks of that many experts at tp = 1."""
    if cfg.experts_held:
        if tp > 1:
            raise ValueError(f"{cfg.name}: experts_held with tp = {tp}")
        return cfg.num_experts // cfg.experts_held, 1
    ep = math.gcd(cfg.num_experts, tp)
    return ep, tp // ep


def capacity(cfg: ModelConfig, num_tokens: int) -> int:
    """Slots per expert for ``num_tokens`` tokens: the even share of the
    T * k pairs times ``capacity_factor``, rounded up to a multiple of 8
    (at least 8)."""
    c = int(math.ceil(num_tokens * cfg.top_k / cfg.num_experts
                      * cfg.capacity_factor))
    return max(8, -(-c // 8) * 8)


def route(cfg: ModelConfig, probs: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of (T, E) router probabilities -> (gate (T, k) float32,
    expert (T, k) int64), the larger probability first and, among equal
    ones, the lower expert index first (a stable descending sort)."""
    k = cfg.top_k
    expert = torch.sort(probs.detach(), dim=-1, descending=True,
                        stable=True).indices[:, :k]
    gate = torch.gather(probs, 1, expert)
    if k > 1:
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return gate, expert


def dispatch_positions(expert: torch.Tensor, num_experts: int, C: int
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(T, k) expert choices -> (pos, keep, counts): each pair's rank
    within its expert in token-major order (T * k,), whether it is below
    the capacity C (T * k,), and the pairs routed to each expert (E,)."""
    onehot = F.one_hot(expert.reshape(-1), num_experts)       # (T*k, E)
    pos = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(-1)
    return pos, pos < C, onehot.sum(0)


def moe_ffn(cfg: ModelConfig, p: dict[str, torch.Tensor], x: torch.Tensor,
            ctx: TPCtx = TP1) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> ((B, S, d) in x's dtype, aux loss float32 scalar).
    ``p`` holds the layer's FFN leaves in x's dtype: ``router`` (d, E),
    ``w1``, ``w3`` (E, d, ff), ``w2`` (E, ff, d), and ``sw1``, ``sw3``
    (d, ff), ``sw2`` (ff, d) with a shared expert; at tp > 1 this rank's
    shards of them (``ctx``), and with ``experts_held`` this card's block
    of the experts (``w1``, ``w3`` (experts_held, d, ff), ``w2``
    (experts_held, ff, d))."""
    with timing.span("moe", device=True):
        return _moe_ffn(cfg, p, x, ctx)


def _moe_ffn(cfg, p, x, ctx):
    B, S, d = x.shape
    T = B * S
    E, k = cfg.num_experts, cfg.top_k
    C = capacity(cfg, T)
    xt = x.reshape(T, d)

    with timing.span("route", device=True):
        probs = torch.softmax((xt @ p["router"]).float(), dim=-1)  # (T, E)
        gate, expert = route(cfg, probs)

        # Switch load-balance loss: E * sum_e mean prob_e * share of
        # pairs_e
        pos, keep, counts = dispatch_positions(expert, E, C)
        ce = counts.float() / (T * k)
        aux = E * torch.sum(probs.mean(0) * ce) * cfg.router_aux_coef

    # ---- dispatch: kept pair i -> row expert_i * C + pos_i of this
    # rank's (this card's) expert block ----
    with timing.span("dispatch", device=True):
        flat_e = expert.reshape(-1)
        ep, fp = moe_factor(cfg, ctx.tp)
        El = E // ep
        first = (ctx.tp_rank() // fp) * El
        if El < E:
            flat_e = flat_e - first
            keep = keep & (flat_e >= 0) & (flat_e < El)
        row = torch.where(keep, flat_e * C + pos, El * C)   # the spare row
        pairs = xt[:, None].expand(T, k, d).reshape(T * k, d)
        expert_in = x.new_zeros(El * C + 1, d).index_put((row,), pairs)
        expert_in = expert_in[:El * C].view(El, C, d)
    if timing.active():
        held = counts[first:first + El]
        kept, routed = keep.sum(), held.sum()
        timing.count("pairs", kept)
        timing.count("dropped", routed - kept)
        timing.count("elsewhere", T * k - routed)
        timing.count("max_load", held.max())

    # ---- experts: batched SwiGLU ----
    with timing.span("experts", device=True):
        h = (F.silu(torch.bmm(expert_in, p["w1"]))
             * torch.bmm(expert_in, p["w3"]))
        expert_out = torch.bmm(h, p["w2"]).reshape(El * C, d)

    # ---- combine: each pair's output (0 when dropped) times its gate,
    # summed over the token's k slots ----
    with timing.span("combine", device=True):
        out_rows = torch.cat([expert_out, expert_out.new_zeros(1, d)])
        contrib = out_rows[row].view(T, k, d)
        y = (contrib * gate.to(contrib.dtype)[..., None]).sum(1)
        if cfg.shared_expert:
            y = y + (F.silu(xt @ p["sw1"]) * (xt @ p["sw3"])) @ p["sw2"]
        y = ctx.psum_tp(y)
    return y.reshape(B, S, d).to(x.dtype), aux

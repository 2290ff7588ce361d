"""RWKV6 ("Finch") time-mix layer: attention-free, with a data-dependent
decay.

Recurrence per head (state S in R^{hd x hd}):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t          w_t = exp(-exp(.)) in (0,1)
    o_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t    (u = per-channel bonus)

The reference writes it in plain jnp as chunked linear attention, and so
does the port, with the same formulas: within a chunk of L tokens the
contribution of step i < t is a masked product weighted by
exp(cw_{t-1} - cw_i) (cw the cumulative log decay), and across chunks a
Python loop carries the (B, H, hd, hd) float32 state where the reference
runs ``lax.scan``.  The mask is applied after the ``exp``, as in the
reference, so both packages compute the same values (above the diagonal
the ``exp`` may overflow; the mask then gives 0 in the forward).  The
decay path mixes the token-shifted input through a LoRA; r, k, v and g
use a learned static token-shift interpolation.  Serving's prefill
returns the state after the last chunk, and ``rwkv_decode`` runs the
recurrence itself, one token at a time (at tp > 1 on this rank's heads'
state, as serving's caches shard it).

At tp > 1 the heads are sharded over the model group: r, k, v, g and
their projections, the bonus ``u`` and the group norm are this rank's
heads', the decay LoRA (a replicated leaf) is computed over all d
channels and sliced to them, and the row-parallel ``wo`` is psum'd.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import TP1, TPCtx

LORA_DIM = 64
RWKV_CHUNK = 32


def rwkv_dims(cfg: ModelConfig, tp: int = 1) -> tuple[int, int]:
    """(heads of one rank, head_dim) of the time-mix."""
    hd = cfg.rwkv_head_dim
    H = cfg.d_model // hd
    if H % tp:
        raise ValueError(f"{cfg.name}: {H} RWKV heads over tp={tp}")
    return H // tp, hd


def rwkv_specs(cfg: ModelConfig, tp: int = 1
               ) -> dict[str, tuple[tuple, int]]:
    """mixer leaf -> (one rank's per-layer shape, init code: 0 zeros, -1
    ones, > 0 normal * code ** -0.5), the reference's
    ``rwkv_param_specs``."""
    d = cfg.d_model
    H, hd = rwkv_dims(cfg, tp)
    dl = H * hd
    return {
        "mu_r": ((d,), 0), "mu_k": ((d,), 0), "mu_v": ((d,), 0),
        "mu_g": ((d,), 0), "mu_w": ((d,), 0),
        "w0": ((d,), 0),
        "w_lora_a": ((d, LORA_DIM), d),
        "w_lora_b": ((LORA_DIM, d), LORA_DIM),
        "proj_r": ((d, dl), d), "proj_k": ((d, dl), d),
        "proj_v": ((d, dl), d), "proj_g": ((d, dl), d),
        "u": ((dl,), 0),
        "ln_x": ((dl,), -1),
        "wo": ((dl, d), d),
    }


def _token_shift(x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) -> the previous token's x, zeros before the first."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def _mix(x: torch.Tensor, xs: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    return x + (xs - x) * mu


def _decay_log(p: dict[str, torch.Tensor], xw: torch.Tensor,
               ctx: TPCtx = TP1, dl: int = 0) -> torch.Tensor:
    """Data-dependent per-channel log decay in (-inf, 0), float32; at
    tp > 1 this rank's ``dl`` channels of it."""
    lora = torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]
    full = -torch.exp(torch.clamp((p["w0"] + lora).float(), -8.0, 8.0))
    if ctx.tp == 1:
        return full
    return full[..., ctx.tp_rank() * dl:(ctx.tp_rank() + 1) * dl]


def _group_rms(x: torch.Tensor, weight: torch.Tensor, eps: float
               ) -> torch.Tensor:
    """Per-head RMS norm of (B, S, H, hd), flattened to (B, S, H * hd)."""
    B, S, H, hd = x.shape
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y.reshape(B, S, H * hd) * weight).to(x.dtype)


def _chunk(S0, rc, kc, vc, wc, u, tri):
    """One chunk: state (B, H, hd, hd) and (B, L, H, hd) float32 r, k, v,
    log decays -> (state at the chunk's end, (B, L, H, hd) output)."""
    cw = torch.cumsum(wc, dim=1)                  # inclusive
    cw_prev = cw - wc                             # exclusive (cw_{t-1})
    # across chunks: o_t += (r_t * e^{cw_{t-1}}) S0
    cross = torch.einsum("blhd,bhde->blhe", rc * torch.exp(cw_prev), S0)
    # within the chunk (i < t); exponents cw_{t-1} - cw_i <= 0 there
    diff = cw_prev[:, :, None] - cw[:, None]      # (B, L, L, H, hd)
    D = torch.where(tri[None, :, :, None, None], torch.exp(diff), 0.0)
    P = torch.einsum("bthd,bihd,btihd->btih", rc, kc, D)
    intra = torch.einsum("btih,bihe->bthe", P, vc)
    # the current token's bonus: (r_t . (u * k_t)) v_t
    bonus = torch.einsum("bthd,hd,bthd->bth", rc, u, kc)[..., None] * vc
    kd = kc * torch.exp(cw[:, -1:] - cw)
    S1 = (torch.exp(cw[:, -1])[..., None] * S0
          + torch.einsum("bihd,bihe->bhde", kd, vc))
    return S1, cross + intra + bonus


def rwkv_forward(cfg: ModelConfig, p: dict[str, torch.Tensor],
                 x: torch.Tensor, *, return_state: bool = False,
                 ctx: TPCtx = TP1):
    """x: (B, S, d) -> (B, S, d) float32 (the reference's output dtype:
    its float32 state meets ``wo`` in float32).  ``p`` holds the layer's
    mixer leaves (``rwkv_specs``) in x's dtype.  With ``return_state``
    it returns (y, (state, x[:, -1:])): the float32 (B, H, hd, hd) state
    after the last token and the token that the next one shifts in, the
    cache ``rwkv_decode`` continues from.  ``ctx`` at tp > 1 shards the
    heads."""
    B, S, d = x.shape
    H, hd = rwkv_dims(cfg, ctx.tp)
    xs = _token_shift(x)
    r = (_mix(x, xs, p["mu_r"]) @ p["proj_r"]).reshape(B, S, H, hd)
    k = (_mix(x, xs, p["mu_k"]) @ p["proj_k"]).reshape(B, S, H, hd)
    v = (_mix(x, xs, p["mu_v"]) @ p["proj_v"]).reshape(B, S, H, hd)
    g = _mix(x, xs, p["mu_g"]) @ p["proj_g"]
    logw = _decay_log(p, _mix(x, xs, p["mu_w"]), ctx, H * hd).reshape(
        B, S, H, hd)
    u = p["u"].reshape(H, hd).float()
    r32, k32, v32 = r.float(), k.float(), v.float()

    L = min(RWKV_CHUNK, S)
    if S % L:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {L}")
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device),
                     diagonal=-1)
    state = torch.zeros((B, H, hd, hd), device=x.device)
    outs = []
    for c in range(0, S, L):
        state, o = _chunk(state, r32[:, c:c + L], k32[:, c:c + L],
                          v32[:, c:c + L], logw[:, c:c + L], u, tri)
        outs.append(o)
    out = torch.cat(outs, dim=1)                  # (B, S, H, hd)

    out = _group_rms(out, p["ln_x"], cfg.norm_eps)
    out = out * F.silu(g.float()).to(out.dtype)
    y = ctx.psum_tp(out @ p["wo"].to(out.dtype))
    return (y, (state, x[:, -1:])) if return_state else y


def rwkv_decode(cfg: ModelConfig, p: dict[str, torch.Tensor],
                x: torch.Tensor,
                cache: tuple[torch.Tensor, torch.Tensor], ctx: TPCtx = TP1
                ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """One token a row: x (B, 1, d), ``cache`` (state (B, H, hd, hd)
    float32 of this rank's H heads, prev_x (B, 1, d) the token before).
    The recurrence itself: o = r S + (r . (u * k)) v, then S <- exp(logw)
    * S + k^T v.  Returns (y (B, 1, d) float32, (the new state, x)).
    ``ctx`` at tp > 1 shards the heads, as ``rwkv_forward``'s."""
    B = x.shape[0]
    H, hd = rwkv_dims(cfg, ctx.tp)
    state, prev_x = cache
    xf, xs = x[:, 0], prev_x[:, 0]
    r = (_mix(xf, xs, p["mu_r"]) @ p["proj_r"]).reshape(B, H, hd)
    k = (_mix(xf, xs, p["mu_k"]) @ p["proj_k"]).reshape(B, H, hd)
    v = (_mix(xf, xs, p["mu_v"]) @ p["proj_v"]).reshape(B, H, hd)
    g = _mix(xf, xs, p["mu_g"]) @ p["proj_g"]
    logw = _decay_log(p, _mix(xf, xs, p["mu_w"]), ctx, H * hd).reshape(
        B, H, hd)
    u = p["u"].reshape(H, hd).float()
    r32, k32, v32 = r.float(), k.float(), v.float()
    o = torch.einsum("bhd,bhde->bhe", r32, state)
    o = o + torch.einsum("bhd,hd,bhd->bh", r32, u, k32)[..., None] * v32
    state = (torch.exp(logw)[..., None] * state
             + torch.einsum("bhd,bhe->bhde", k32, v32))
    o = _group_rms(o[:, None], p["ln_x"], cfg.norm_eps)        # (B, 1, dl)
    o = o * F.silu(g.float())[:, None].to(o.dtype)
    return ctx.psum_tp(o @ p["wo"].to(o.dtype)), (state, x)

"""Mamba selective-SSM layer (Jamba's sequence mixer): the sequence
forward of training and prefill, and serving's one-token step.

Diagonal selective state space, per channel and state entry:
    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t * x_t
    y_t = C_t . h_t + D * x_t

The reference writes it in plain jnp: a depthwise causal conv, then the
recurrence in chunks of ``MAMBA_CHUNK`` steps, each chunk a
``jax.lax.associative_scan`` while ``lax.scan`` carries the float32
(B, d_inner, d_state) state across chunks.  The port keeps the chunks
(a Python loop carries the state) and runs each chunk's scan as the
same odd/even recursion that ``associative_scan`` unrolls: combine
adjacent pairs, scan the half-length result, fill the even positions
from it, interleave.  Following the same combine tree keeps the port's
rounding closest to the reference's; each level is a handful of
elementwise operations over the whole chunk, so a chunk of 64 costs 6
levels, not 64 steps.  The conv is a sum of shifted products in the
reference's order of additions (not ``conv1d``, whose depthwise
backward on the card is not guaranteed deterministic).  Serving's cache
is the last state and the conv's last width - 1 inputs (at tp > 1 those
of this rank's channels); a decode step is the forward on one token from
it (the reference's ``mamba_decode``, its chunk of 1 being a chunk of
min(``MAMBA_CHUNK``, 1) here).

At tp > 1 the d_inner channels are sharded over the model group (every
leaf but the out-projection's output side is this rank's channels'), the
out-projection is row-parallel and psum'd.  As in the reference, dt, B
and C come from this rank's channels alone (``x_proj`` is not psum'd).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import TP1, TPCtx

MAMBA_CHUNK = 64

# init code of A_log: log(1..d_state) in every channel
A_LOG_INIT = -2


def mamba_dims(cfg: ModelConfig, tp: int = 1) -> int:
    """d_inner of one rank: the channels of its scan."""
    di = cfg.mamba_expand * cfg.d_model
    if di % tp:
        raise ValueError(f"{cfg.name}: d_inner {di} over tp={tp}")
    return di // tp


def mamba_specs(cfg: ModelConfig, tp: int = 1
                ) -> dict[str, tuple[tuple, int]]:
    """mixer leaf -> (one rank's per-layer shape, init code: 0 zeros, -1
    ones, -2 ``A_LOG_INIT``, > 0 normal * code ** -0.5), the reference's
    ``mamba_param_specs``."""
    d, di, dil = cfg.d_model, mamba_dims(cfg), mamba_dims(cfg, tp)
    st, rk, cw = cfg.mamba_d_state, cfg.dt_rank, cfg.mamba_conv
    return {
        "in_proj": ((d, 2 * dil), d),
        "conv_w": ((cw, dil), 0),
        "conv_b": ((dil,), 0),
        "x_proj": ((dil, rk + 2 * st), dil),
        "dt_proj": ((rk, dil), rk),
        "dt_bias": ((dil,), 0),
        "A_log": ((dil, st), A_LOG_INIT),
        "D": ((dil,), -1),
        "out_proj": ((dil, d), di),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 conv_state: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along S.  x: (B, S, di); w: (width, di);
    b: (di,); ``conv_state`` (B, width - 1, di): the inputs before x
    (None: zeros).  y = b + w[0] * xp[0:S] + w[1] * xp[1:S+1] + ..., xp
    being x after those width - 1 inputs, added in that order.  Returns
    (y, the last width - 1 rows of xp: the next call's conv_state)."""
    width, S = w.shape[0], x.shape[1]
    if conv_state is None:
        xp = F.pad(x, (0, 0, width - 1, 0))
    else:
        xp = torch.cat([conv_state, x], dim=1)
    y = torch.zeros_like(x) + b
    for j in range(width):
        y = y + w[j] * xp[:, j:j + S]
    return y, xp[:, S:]


def _combine(a, b):
    """(decay, drive) of an earlier span ``a`` then a later span ``b``."""
    return a[0] * b[0], a[1] * b[0] + b[1]


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], odd[1], ... along dim 1 (``even`` as long
    as ``odd`` or one longer)."""
    n = odd.shape[1]
    out = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return torch.cat([out, even[:, n:]], dim=1) if even.shape[1] > n else out


def _assoc_scan(elems):
    """Inclusive scan of (decay, drive) pairs along dim 1 under
    ``_combine``, in the recursion of ``jax.lax.associative_scan``."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = _combine([e[:, 0:-1:2] for e in elems],
                       [e[:, 1::2] for e in elems])
    odd = _assoc_scan(reduced)
    if n % 2 == 0:
        even = _combine([e[:, :-1] for e in odd], [e[:, 2::2] for e in elems])
    else:
        even = _combine(odd, [e[:, 2::2] for e in elems])
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def _ssm_scan(decay: torch.Tensor, drive: torch.Tensor, h0: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """h_t = decay_t * h_{t-1} + drive_t; decay, drive: (B, S, di, st);
    h0: (B, di, st).  Returns (the last state, every step's state)."""
    S = decay.shape[1]
    L = min(MAMBA_CHUNK, S)
    if S % L:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {L}")
    h, hs = h0, []
    for c in range(0, S, L):
        cd, ch = _assoc_scan([decay[:, c:c + L], drive[:, c:c + L]])
        states = cd * h[:, None] + ch
        h = states[:, -1]
        hs.append(states)
    return h, torch.cat(hs, dim=1)


def mamba_forward(cfg: ModelConfig, p: dict[str, torch.Tensor],
                  x: torch.Tensor, *,
                  cache: tuple[torch.Tensor, torch.Tensor] | None = None,
                  return_state: bool = False, ctx: TPCtx = TP1):
    """x: (B, S, d) -> (B, S, d).  ``p`` holds the layer's Mamba leaves in
    x's dtype; from the conv on the layer computes in float32, and the
    output projection in x's dtype, as the reference.  ``cache`` = (h
    (B, di, d_state) float32, conv_state (B, width - 1, di)) starts the
    scan and the conv where an earlier call left them (None: zeros); with
    ``return_state`` it returns (y, (the last h, the next conv_state)).
    ``ctx`` at tp > 1 shards the channels."""
    B = x.shape[0]
    di = mamba_dims(cfg, ctx.tp)
    st, rk = cfg.mamba_d_state, cfg.dt_rank
    xin, z = (x @ p["in_proj"]).split(di, dim=-1)      # (B, S, di) each
    xc, conv_state = _causal_conv(xin, p["conv_w"], p["conv_b"],
                                  None if cache is None else cache[1])
    xc = F.silu(xc.float())
    proj = xc @ p["x_proj"].float()
    dt_raw, Bs, Cs = proj.split([rk, st, st], dim=-1)
    dt = F.softplus(dt_raw @ p["dt_proj"].float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())                 # (di, st)
    decay = torch.exp(dt[..., None] * A)                # (B, S, di, st)
    drive = (dt * xc)[..., None] * Bs[:, :, None, :]
    h0 = (torch.zeros((B, di, st), dtype=torch.float32, device=x.device)
          if cache is None else cache[0])
    h, hs = _ssm_scan(decay, drive, h0)
    y = torch.einsum("bsdn,bsn->bsd", hs, Cs)
    y = y + p["D"].float() * xc
    y = y * F.silu(z.float())
    out = ctx.psum_tp(y.to(x.dtype) @ p["out_proj"])
    return (out, (h, conv_state)) if return_state else out

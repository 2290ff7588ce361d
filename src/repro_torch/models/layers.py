"""Primitive layers of the dense decoder: RMSNorm, RoPE, SwiGLU, the
chunked cross-entropy loss over the unpadded vocabulary and serving's
logits.
Numerics follow the reference package: norms and the loss in float32,
matmuls in the compute dtype."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * weight


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding over the two halves of the head dim.
    x: (B, S, heads, head_dim); positions: (..., S), e.g. (S,) for a
    sequence from 0 or (B, 1) for one decode token a row."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions.float()[..., None, None] * freqs  # (..., S, 1, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def _ce_chunk(w: torch.Tensor, x: torch.Tensor, labels: torch.Tensor
              ) -> torch.Tensor:
    """The cross-entropy summed over one (B, C, d) slice, in float32: the
    reference's ``_ce_chunk`` (the max shift held constant)."""
    logits = (x @ w).float()
    m = torch.amax(logits, dim=-1).detach()
    lse = m + torch.log(torch.sum(torch.exp(logits - m[..., None]), dim=-1))
    picked = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.sum(lse - picked)


def lm_head_loss(w: torch.Tensor, x: torch.Tensor, labels: torch.Tensor,
                 chunk: int = 512) -> torch.Tensor:
    """Mean softmax cross-entropy; w: (d, V); x: (B, S, d).

    As the reference's: where ``S <= chunk`` or ``S % chunk`` one chunk,
    ``sum(lse - picked) / (B*S)``; otherwise the float32 sums of the
    sequence chunks ``[c*chunk, (c+1)*chunk)`` are added in order and the
    total divided by B*S.  With grad enabled each chunk runs under a
    checkpoint, so that one (B, chunk, V) float32 logits tensor lives at a
    time and the backward recomputes it."""
    B, S, _ = x.shape
    if S <= chunk or S % chunk:
        return _ce_chunk(w, x, labels) / (B * S)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(0, S, chunk):
        xc, lc = x[:, c:c + chunk], labels[:, c:c + chunk]
        if torch.is_grad_enabled():
            part = checkpoint(_ce_chunk, w, xc, lc, use_reentrant=False)
        else:
            part = _ce_chunk(w, xc, lc)
        total = total + part
    return total / (B * S)


def lm_head_logits(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Serving's logits: the matmul in x's dtype, then float32.
    w: (d, V); x: (B, d) -> (B, V)."""
    return (x @ w).float()

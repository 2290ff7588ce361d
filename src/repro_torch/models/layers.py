"""Primitive layers of the dense decoder: RMSNorm, RoPE, SwiGLU, the
cross-entropy loss over the unpadded vocabulary and serving's logits.
Numerics follow the reference package: norms and the loss in float32,
matmuls in the compute dtype."""
from __future__ import annotations

import torch
import torch.nn.functional as F


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


def lm_head_loss(w: torch.Tensor, x: torch.Tensor, labels: torch.Tensor
                 ) -> torch.Tensor:
    """Mean softmax cross-entropy; w: (d, V); x: (B, S, d)."""
    logits = (x @ w).float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.mean(lse - picked)


def lm_head_logits(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Serving's logits: the matmul in x's dtype, then float32.
    w: (d, V); x: (B, d) -> (B, V)."""
    return (x @ w).float()

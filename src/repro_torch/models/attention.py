"""Causal self-attention with grouped-query heads and RoPE.

The reference computes attention in plain jnp (flash-style, in float32)
and no TPU kernel lies on this path.  Here PyTorch's
``scaled_dot_product_attention`` takes XLA's fused loop's place, on
float32 inputs as in the reference; the result returns to the compute
dtype for the output projection.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import rope


def causal_attention(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                     wv: torch.Tensor, wo: torch.Tensor, *, num_heads: int,
                     num_kv_heads: int, head_dim: int, theta: float
                     ) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d)."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    q = rope((x @ wq).reshape(B, S, num_heads, head_dim), positions, theta)
    k = rope((x @ wk).reshape(B, S, num_kv_heads, head_dim), positions, theta)
    v = (x @ wv).reshape(B, S, num_kv_heads, head_dim)
    # one kv head serves num_heads // num_kv_heads consecutive q heads
    ratio = num_heads // num_kv_heads
    k = k.repeat_interleave(ratio, dim=2)
    v = v.repeat_interleave(ratio, dim=2)
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2).float(), k.transpose(1, 2).float(),
        v.transpose(1, 2).float(), is_causal=True)
    out = out.transpose(1, 2).to(x.dtype).reshape(B, S, num_heads * head_dim)
    return out @ wo

"""Causal self-attention: GQA with RoPE, optional qk-norm and qkv bias;
full, sliding-window and chunked variants; and the VLM's tanh-gated
cross-attention to image embeddings.

The reference computes attention outside any TPU kernel, as a
flash-style loop in plain jnp (``_flash``), and so does the port: a
Python loop over at most ``MAX_Q_BLOCKS`` query blocks, and for each
only the kv blocks that the causal and window structure admits, in
float32 with a running max and sum.  Every operation in it (matmuls,
elementwise, reductions along one axis, and the sum that is the
backward of the GQA ``expand``) is deterministic on the card, so two
backward passes on the same inputs give the same bits.
"""
from __future__ import annotations

import torch

from .config import CHUNKED, SLIDING, ModelConfig
from .layers import rms_norm, rope

NEG_INF = -1e30
MAX_Q_BLOCKS = 32


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, window: int, q_block: int = 512,
           kv_block: int = 512) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, Skv, H, hd) head-expanded; window <= 0:
    unlimited.  Returns (B, S, H, hd) in q's dtype.

    The running max only shifts the exponents, and the result does not
    depend on it, so it is taken out of the graph: autograd then keeps
    one (q_block, kv_block) probability tile per head and kv block.
    """
    B, S, H, hd = q.shape
    Skv = k.shape[1]
    q_block = min(max(q_block, -(-S // MAX_Q_BLOCKS)), S)
    while S % q_block:
        q_block += 1
    kv_block = min(kv_block, Skv)
    if Skv % kv_block:
        kv_block = Skv  # one kv block for an extent the block does not divide
    nq, nkv = S // q_block, Skv // kv_block
    qt = q.transpose(1, 2).float() * hd ** -0.5          # (B, H, S, hd)
    kt = k.transpose(1, 2).float()
    vt = v.transpose(1, 2).float()
    ar_q = torch.arange(q_block, device=q.device)
    ar_k = torch.arange(kv_block, device=q.device)

    outs = []
    for qi in range(nq):
        q_start = qi * q_block
        qb = qt[:, :, q_start:q_start + q_block]
        hi = min(-(-(q_start + q_block) // kv_block), nkv) if causal else nkv
        lo = max((q_start - window) // kv_block, 0) if window > 0 else 0
        m = torch.full((B, H, q_block), NEG_INF, device=q.device)
        l = torch.zeros((B, H, q_block), device=q.device)
        acc = torch.zeros((B, H, q_block, hd), device=q.device)
        for ki in range(lo, hi):
            k_start = ki * kv_block
            kb = kt[:, :, k_start:k_start + kv_block]
            vb = vt[:, :, k_start:k_start + kv_block]
            s = qb @ kb.transpose(-1, -2)
            # a block wholly inside the causal and window limits needs no
            # mask (the reference masks it with all-True)
            q_last, k_last = q_start + q_block - 1, k_start + kv_block - 1
            cut_causal = causal and k_last > q_start
            cut_window = window > 0 and k_start <= q_last - window
            if cut_causal or cut_window:
                qpos = (q_start + ar_q)[:, None]
                kpos = (k_start + ar_k)[None, :]
                mask = torch.ones((q_block, kv_block), dtype=torch.bool,
                                  device=q.device)
                if causal:
                    mask &= qpos >= kpos
                if window > 0:
                    mask &= kpos > qpos - window
                s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1)).detach()
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + p @ vb
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.cat(outs, dim=2)                          # (B, H, S, hd)
    return out.transpose(1, 2).to(q.dtype)


def _expand_kv(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, H, hd): kv head j serves the
    H // KV consecutive q heads from j * H // KV.  The backward of
    ``expand`` is a sum over the copies."""
    B, S, KV, hd = t.shape
    ratio = num_heads // KV
    return t[:, :, :, None].expand(B, S, KV, ratio, hd).reshape(
        B, S, num_heads, hd)


def attn_forward(cfg: ModelConfig, p: dict[str, torch.Tensor],
                 x: torch.Tensor, kind: str, *, q_block: int = 512,
                 kv_block: int = 512) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).  ``p`` holds the layer's attention
    leaves in x's dtype (``wq``, ``wk``, ``wv``, ``wo``, and ``bq``,
    ``bk``, ``bv`` with qkv bias, ``q_norm``, ``k_norm`` with qk-norm);
    ``kind`` is the slot's attention kind."""
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    positions = torch.arange(S, device=x.device)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    k, v = _expand_kv(k, H), _expand_kv(v, H)
    blocks = dict(q_block=q_block, kv_block=kv_block)

    if kind == CHUNKED and S > cfg.chunk:
        c = cfg.chunk
        n_full = S // c
        body = n_full * c

        def fold(t):
            return t[:, :body].reshape(B * n_full, c, H, hd)

        out = _flash(fold(q), fold(k), fold(v), causal=True, window=0,
                     **blocks).reshape(B, body, H, hd)
        if body < S:  # a trailing partial chunk is its own causal block
            tail = _flash(q[:, body:], k[:, body:], v[:, body:], causal=True,
                          window=0, **blocks)
            out = torch.cat([out, tail], dim=1)
    else:
        window = cfg.window if kind == SLIDING else 0
        out = _flash(q, k, v, causal=True, window=window, **blocks)
    return out.reshape(B, S, H * hd) @ p["wo"]


def cross_attn_forward(cfg: ModelConfig, p: dict[str, torch.Tensor],
                       x: torch.Tensor, vision: torch.Tensor
                       ) -> torch.Tensor:
    """Gated cross-attention: x (B, S, d) attends to ``vision`` (B, S_img,
    d) image embeddings, without RoPE, qk-norm or a causal mask; returns
    tanh(gate) * y.  ``p`` holds ``wq``, ``wk``, ``wv``, ``wo`` and
    ``gate`` in x's dtype.  K and V are computed in the promoted dtype of
    the embeddings and the weights, as the reference's jnp promotes a
    float32 stub against bf16 weights; the attention returns q's dtype."""
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    kv_dtype = torch.promote_types(vision.dtype, x.dtype)
    v_in = vision.to(kv_dtype)
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (v_in @ p["wk"].to(kv_dtype)).reshape(B, -1, KV, hd)
    v = (v_in @ p["wv"].to(kv_dtype)).reshape(B, -1, KV, hd)
    out = _flash(q, _expand_kv(k, H), _expand_kv(v, H), causal=False,
                 window=0, q_block=512, kv_block=512)
    y = out.reshape(B, S, H * hd) @ p["wo"]
    return torch.tanh(p["gate"]) * y

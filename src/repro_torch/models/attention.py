"""Causal self-attention: GQA with RoPE, optional qk-norm and qkv bias;
full, sliding-window and chunked variants; the VLM's tanh-gated
cross-attention to image embeddings; and serving's decode of one token
against a ring-addressed KV cache.

The reference computes attention outside any TPU kernel, as a
flash-style loop in plain jnp (``_flash``), and so does the port's plain
version: a Python loop over at most ``MAX_Q_BLOCKS`` query blocks, and
for each only the kv blocks that the causal and window structure admits,
in float32 with a running max and sum.  Every operation in it (matmuls,
elementwise, reductions along one axis, and the sum that is the
backward of the GQA ``expand``) is deterministic on the card, so two
backward passes on the same inputs give the same bits.

``attn_forward``'s self-attention on CUDA tensors runs the hand-written
kernels of ``kernels/attention.py`` instead (forward and backward on the
tensor cores, float32 wherever ``_flash`` is, and deterministic too),
which read k and v through a map of kv heads (``_kv_heads``) rather than
an expanded copy; they take bfloat16 and float32 tensors and raise on
any other dtype, with no fall-back.  ``q_block`` and ``kv_block`` are
the plain loop's alone.  Meta tensors (the dry run) take the kernels'
operators, which allocate what the card allocates.  Tensors on the CPU
keep ``_flash``, and so do the VLM's cross-attention (its kv in the
embeddings' promoted dtype, without a causal mask) and serving's decode
step.

At tp > 1 (``ctx``) the query heads are padded to a multiple of tp and
sharded over the model group, the small kv projection is replicated, and
each local q head reads the kv head of its *global* index; the padding
heads' outputs are masked to zero, and the row-parallel output
projection is psum'd.

Serving's caches are sequence-sharded, as the reference's: the ring of C
slots (rounded up to a multiple of ``cache_shards``) is cut into
``cache_shards`` runs of C_local slots, and shard ``slot // C_local``
holds a token, the shards numbered over the groups of ``seq_ctxs`` (the
model group; for batch-1 long context the data group, then the model
group).  A decode step all-gathers the one-token q over the model group,
so that every rank scores every (padded) head against its own sequence
shard; the running max and the softmax sums of the shards are combined
with ``pmax`` and ``psum`` over each group in turn, the token's own key
is folded in once, and each rank keeps its own heads for the
row-parallel output projection.  At tp = 1 with one shard nothing is
gathered or reduced.
"""
from __future__ import annotations

import itertools

import torch

from repro_torch.kernels.attention import attention as attention_kernel
from .config import CHUNKED, SLIDING, ModelConfig
from .layers import (TP1, TPCtx, head_mask, make_dims, pad_to, rms_norm,
                     rope, shard_of, tp_all_gather)

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


def _kv_index(cfg: ModelConfig, first: int, count: int) -> list[int]:
    """The kv head of each of ``count`` q heads from global head
    ``first``: min(g // (H // KV), KV - 1), the padding heads past H on
    the last kv head (the reference's ``_expand_kv`` and
    ``_expand_kv_all_heads``)."""
    ratio = max(1, cfg.num_heads // cfg.num_kv_heads)
    return [min((first + h) // ratio, cfg.num_kv_heads - 1)
            for h in range(count)]


def _kv_heads(cfg: ModelConfig, ctx: TPCtx, count: int) -> list[int]:
    """The kv head of each of this rank's ``count`` q heads, as ``_expand``
    assigns them: by the heads' global indices, the padding heads at tp >
    1 on the last kv head."""
    return _kv_index(cfg, ctx.tp_rank() * count, count)


def _take_heads(t: torch.Tensor, idx: list[int]) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, len(idx), hd), head h holding kv head
    idx[h].  Consecutive heads share a kv head, so the copy is a
    concatenation of expanded runs, whose backward sums each run (no
    scatter)."""
    B, S, _, hd = t.shape
    return torch.cat([t[:, :, j:j + 1].expand(B, S, len(list(run)), hd)
                      for j, run in itertools.groupby(idx)], dim=2)


def _expand_kv_local(t: torch.Tensor, cfg: ModelConfig, ctx: TPCtx
                     ) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, heads_local, hd) at tp > 1: local q head
    h reads the kv head of its *global* index rank * heads_local + h."""
    hl = make_dims(cfg, ctx.tp).heads_local
    return _take_heads(t, _kv_index(cfg, ctx.tp_rank() * hl, hl))


def _expand(t: torch.Tensor, cfg: ModelConfig, ctx: TPCtx) -> torch.Tensor:
    return (_expand_kv(t, cfg.num_heads) if ctx.tp == 1
            else _expand_kv_local(t, cfg, ctx))


def _expand_all(t: torch.Tensor, cfg: ModelConfig, ctx: TPCtx
                ) -> torch.Tensor:
    """(B, S, KV, hd) -> one kv head for each of the model's *global*
    q heads, padded to a multiple of tp (the reference's
    ``_expand_kv_all_heads``)."""
    if ctx.tp == 1:
        return _expand_kv(t, cfg.num_heads)
    return _take_heads(t, _kv_index(cfg, 0, make_dims(cfg, ctx.tp).n_heads))


def _combine_heads(cfg: ModelConfig, p: dict[str, torch.Tensor],
                   out: torch.Tensor, ctx: TPCtx) -> torch.Tensor:
    """(B, S, heads, hd) attention output -> (B, S, d): at tp > 1 the
    padding heads masked, then the row-parallel ``wo`` psum'd."""
    B, S = out.shape[:2]
    if ctx.tp > 1:
        mask = head_mask(ctx, cfg, make_dims(cfg, ctx.tp), out.device)
        out = out * mask[None, None, :, None].to(out.dtype)
    return ctx.psum_tp(out.reshape(B, S, -1) @ p["wo"])


def _project_qkv(cfg: ModelConfig, p: dict[str, torch.Tensor],
                 x: torch.Tensor, xkv: torch.Tensor,
                 positions: torch.Tensor | None
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, d), xkv: (B, Skv, d) -> q (B, S, H, hd) (H the heads of
    ``wq``: this rank's at tp > 1), k and v (B, Skv, KV, hd): the projections, the qkv bias and qk-norm where ``p`` has
    them, then RoPE at ``positions`` ((..., S); None: no RoPE).  K and V
    are computed in xkv's dtype."""
    B, S, _ = x.shape
    KV, hd = cfg.num_kv_heads, cfg.head_dim_
    q = x @ p["wq"]
    k = xkv @ p["wk"].to(xkv.dtype)
    v = xkv @ p["wv"].to(xkv.dtype)
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, -1, hd)
    k = k.reshape(B, -1, KV, hd)
    v = v.reshape(B, -1, KV, hd)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def cache_spec(cfg: ModelConfig, kind: str, max_len: int, shards: int = 1
               ) -> tuple[int, int]:
    """(C, C_local): the slots of one attention layer's decode cache and
    of each of its ``shards`` sequence shards.  C is the window or the
    chunk where ``kind`` limits what a token sees, else ``max_len``,
    rounded up to a multiple of ``shards`` (which changes the ring's
    modulus, as in the reference); a token at position t lives in slot
    t % C, on shard slot // C_local."""
    if kind == SLIDING:
        C = min(cfg.window, max_len)
    elif kind == CHUNKED:
        C = min(cfg.chunk, max_len)
    else:
        C = max_len
    C = pad_to(C, shards)
    return C, C // shards


def _self_attention(cfg: ModelConfig, ctx: TPCtx, q: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor, kind: str, *,
                    q_block: int = 512, kv_block: int = 512
                    ) -> torch.Tensor:
    """q (B, S, H, hd), k, v (B, S, KV, hd) -> (B, S, H, hd): causal
    attention of the slot's ``kind`` (a sliding window, or chunks folded
    into the batch with a trailing partial chunk on its own), by
    ``_flash`` over kv heads expanded to q's for CPU tensors, else by the
    kernels (their operators on the meta device)."""
    B, S, H, hd = q.shape
    if q.device.type != "cpu":
        heads = _kv_heads(cfg, ctx, H)

        def attend(q, k, v, window):
            return attention_kernel(q, k, v, heads, window)
    else:
        k, v = _expand(k, cfg, ctx), _expand(v, cfg, ctx)

        def attend(q, k, v, window):
            return _flash(q, k, v, causal=True, window=window,
                          q_block=q_block, kv_block=kv_block)

    if kind != CHUNKED or S <= cfg.chunk:
        return attend(q, k, v, cfg.window if kind == SLIDING else 0)
    c = cfg.chunk
    n_full = S // c
    body = n_full * c

    def fold(t):
        return t[:, :body].reshape(B * n_full, c, *t.shape[2:])

    out = attend(fold(q), fold(k), fold(v), 0).reshape(B, body, H, hd)
    if body < S:  # a trailing partial chunk is its own causal block
        tail = attend(q[:, body:], k[:, body:], v[:, body:], 0)
        out = torch.cat([out, tail], dim=1)
    return out


def attn_forward(cfg: ModelConfig, p: dict[str, torch.Tensor],
                 x: torch.Tensor, kind: str, *, return_cache: bool = False,
                 max_len: int = 0, q_block: int = 512, kv_block: int = 512,
                 ctx: TPCtx = TP1, cache_shards: int = 1, seq_ctxs=()):
    """x: (B, S, d) -> (B, S, d).  ``p`` holds the layer's attention
    leaves in x's dtype (``wq``, ``wk``, ``wv``, ``wo``, and ``bq``,
    ``bk``, ``bv`` with qkv bias, ``q_norm``, ``k_norm`` with qk-norm);
    ``kind`` is the slot's attention kind.  ``ctx`` at tp > 1 shards the
    q heads.

    With ``return_cache`` it returns (y, (k, v)): this rank's shard of
    the decode cache, ``cache_spec(cfg, kind, max_len or S,
    cache_shards)``'s C_local slots, (B, C_local, KV, hd) in k's dtype.
    Of the last min(C, S) tokens, each goes to slot t % C of the ring and
    so to shard (t % C) // C_local; this rank's shard (``shard_of(
    seq_ctxs)``) keeps its own tokens' k (after RoPE) and v, the other
    slots zero: ``attn_decode``'s ring addressing."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x, x, torch.arange(S, device=x.device))
    out = _self_attention(cfg, ctx, q, k, v, kind, q_block=q_block,
                          kv_block=kv_block)
    y = _combine_heads(cfg, p, out, ctx)
    if not return_cache:
        return y
    C, C_local = cache_spec(cfg, kind, max_len or S, cache_shards)
    t = torch.arange(S - min(C, S), S)                  # the kept tokens
    slot = t % C
    mine = slot // C_local == shard_of(seq_ctxs)[1]     # host-side: no sync
    src, dst = t[mine].to(x.device), (slot[mine] % C_local).to(x.device)
    kk = k.new_zeros((B, C_local) + k.shape[2:])
    vv = v.new_zeros((B, C_local) + v.shape[2:])
    kk[:, dst] = k[:, src]
    vv[:, dst] = v[:, src]
    return y, (kk, vv)


def attn_decode(cfg: ModelConfig, p: dict[str, torch.Tensor],
                x: torch.Tensor, pos: torch.Tensor,
                cache: tuple[torch.Tensor, torch.Tensor], kind: str, *,
                ctx: TPCtx = TP1, cache_shards: int = 1, seq_ctxs=()
                ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """One token a row against the ring cache: x (B, 1, d), ``pos`` (B,)
    its absolute positions, ``cache`` (k, v) of (B, C_local, KV, hd),
    this rank's shard of a ring of C = C_local * ``cache_shards`` slots
    sequence-sharded over ``seq_ctxs`` (``attn_forward``'s layout).
    Returns (y (B, 1, d), the cache), whose slot pos % C now holds the
    token's k and v on the shard that owns it (written in place).

    Each slot's absolute position follows from ``pos`` and the ring; a
    slot is seen when it holds a position in [0, pos) that the window or
    the chunk admits.  The scores and the softmax run in float32, masked
    with the finite ``NEG_INF``, so that an empty cache weighs nothing
    once the token's own key is folded in (exactly once, after the
    cache's slots).  At tp > 1 the q heads are all-gathered over the
    model group and every rank scores all of them against its shard; the
    shards' running max is ``pmax``'d and their softmax sums ``psum``'d
    over each group of ``seq_ctxs`` in turn, and the rank's own heads go
    through the row-parallel ``wo``."""
    B = x.shape[0]
    hd = cfg.head_dim_
    q, k_new, v_new = _project_qkv(cfg, p, x, x, pos[:, None])
    if ctx.tp > 1:
        q = torch.cat(list(tp_all_gather(ctx, q)), dim=2)       # all heads
    k_cache, v_cache = cache
    C_local = k_cache.shape[1]
    C = C_local * cache_shards
    shard = shard_of(seq_ctxs)[1]
    rows = torch.arange(B, device=x.device)
    slot = (pos % C).long()
    local = slot % C_local
    k_in = k_new[:, 0].to(k_cache.dtype)
    v_in = v_new[:, 0].to(v_cache.dtype)
    if cache_shards > 1 or shard:       # only the owner shard keeps it
        mine = (slot // C_local == shard)[:, None, None]
        k_in = torch.where(mine, k_in, k_cache[rows, local])
        v_in = torch.where(mine, v_in, v_cache[rows, local])
    k_cache[rows, local] = k_in
    v_cache[rows, local] = v_in

    gslot = shard * C_local + torch.arange(C_local, device=x.device)
    delta = (pos % C)[:, None] - gslot
    delta = torch.where(delta < 0, delta + C, delta)
    slot_pos = pos[:, None] - delta                          # (B, C_local)
    now = pos[:, None]
    valid = (slot_pos >= 0) & (slot_pos <= now)
    if kind == SLIDING:
        valid &= slot_pos > now - cfg.window
    elif kind == CHUNKED:
        valid &= slot_pos >= (now // cfg.chunk) * cfg.chunk
    valid &= slot_pos != now

    qs = q.float() * hd ** -0.5                              # (B,1,H,hd)
    ke, ve = _expand_all(k_cache, cfg, ctx), _expand_all(v_cache, cfg, ctx)
    s = torch.einsum("bqhd,bchd->bhqc", qs, ke.float())
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1)                                       # (B,H,1)
    for c in seq_ctxs:
        m = c.pmax(m)
    ps = torch.exp(s - m[..., None])
    l = ps.sum(dim=-1)
    acc = torch.einsum("bhqc,bchd->bhqd", ps, ve.float())
    for c in seq_ctxs:
        l, acc = c.psum(l), c.psum(acc)
    # the new token's own key and value, always visible to itself
    ke_new, ve_new = _expand_all(k_new, cfg, ctx), _expand_all(v_new, cfg,
                                                               ctx)
    s_new = torch.einsum("bqhd,bqhd->bhq", qs, ke_new.float())
    m2 = torch.maximum(m, s_new)
    corr = torch.exp(m - m2)
    pn = torch.exp(s_new - m2)
    l2 = l * corr + pn
    acc2 = (acc * corr[..., None]
            + pn[..., None] * ve_new.float().transpose(1, 2))
    out = (acc2 / torch.clamp(l2, min=1e-30)[..., None]).transpose(1, 2)
    if ctx.tp > 1:          # back to this rank's heads
        hl = make_dims(cfg, ctx.tp).heads_local
        out = out[:, :, ctx.tp_rank() * hl:(ctx.tp_rank() + 1) * hl]
    return _combine_heads(cfg, p, out.to(x.dtype), ctx), (k_cache, v_cache)


def cross_attn_forward(cfg: ModelConfig, p: dict[str, torch.Tensor],
                       x: torch.Tensor, vision: torch.Tensor,
                       ctx: TPCtx = TP1) -> torch.Tensor:
    """Gated cross-attention: x (B, S, d) attends to ``vision`` (B, S_img,
    d) image embeddings, without RoPE, qk-norm or a causal mask; returns
    tanh(gate) * y.  ``p`` holds ``wq``, ``wk``, ``wv``, ``wo`` and
    ``gate`` in x's dtype.  K and V are computed in the promoted dtype of
    the embeddings and the weights, as the reference's jnp promotes a
    float32 stub against bf16 weights; the attention returns q's dtype.
    A decode step runs it on its one token."""
    kv_dtype = torch.promote_types(vision.dtype, x.dtype)
    q, k, v = _project_qkv(cfg, p, x, vision.to(kv_dtype), None)
    out = _flash(q, _expand(k, cfg, ctx), _expand(v, cfg, ctx),
                 causal=False, window=0, q_block=512, kv_block=512)
    return torch.tanh(p["gate"]) * _combine_heads(cfg, p, out, ctx)

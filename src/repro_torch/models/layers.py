"""Primitive layers of the decoder: RMSNorm, RoPE, SwiGLU, the chunked
cross-entropy loss and serving's logits, and the tensor-parallel
primitives of the reference's ``models/layers.py``.
Numerics follow the reference package: norms and the loss in float32,
matmuls in the compute dtype.

Tensor parallelism (tp > 1) is written out with explicit collectives over
the model group, as the reference writes it inside ``jax.shard_map``:

  * a column-parallel matmul holds its weight's shard of output columns
    and needs no collective (its input is the same on every rank);
  * a row-parallel matmul holds its weight's shard of input rows, and
    ``TPCtx.psum_tp`` sums the partial outputs over the group;
  * the embedding and the LM head are sharded over the vocabulary: a
    lookup sums each rank's rows (zero where the id lies on another
    rank), and the cross-entropy combines the ranks' softmax sums.

Heads, FFN width and vocabulary are padded to multiples of tp (``Dims``).
``psum_tp``'s backward is another all-reduce sum, the transpose that the
reference's ``psum`` has under ``shard_map(check_vma=False)``: each rank
backpropagates its own copy of the (replicated) loss, so a sharded leaf's
gradient is tp times the tp = 1 gradient, and a replicated leaf's (the kv
projections, the norms, the router) is tp times that rank's own partial.
That is what the reference computes, and the port keeps it.

At tp = 1 ``psum_tp`` is the identity and no collective is issued.
While a step is being recorded (``repro_torch.timing``) each all-reduce
and all-gather of the model group is a device span, ``tp_all_reduce`` or
``tp_all_gather``, with the ``bytes`` of this rank's input.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Iterator, NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import timing
from .config import ModelConfig

# the model groups the collectives run over, by the name a TPCtx holds
_GROUPS: dict[str, object] = {}


@contextlib.contextmanager
def group_scope() -> Iterator[None]:
    """Forgets on exit the groups that ``TPCtx.over`` registered inside,
    for a caller that destroys those process groups on its way out."""
    before = set(_GROUPS)
    try:
        yield
    finally:
        for name in set(_GROUPS) - before:
            del _GROUPS[name]


@torch.library.custom_op("repro_torch::tp_all_reduce", mutates_args=())
def tp_all_reduce(x: torch.Tensor, group: str, op: str) -> torch.Tensor:
    """A new tensor: x reduced (``op`` "sum" or "max") over the model
    group registered as ``group``.  A functional operator, so that a
    selective checkpoint can keep its output (``remat="psum"``)."""
    out = x.clone(memory_format=torch.contiguous_format)
    with timing.span("tp_all_reduce", device=True):
        timing.count("bytes", out.numel() * out.element_size())
        dist.all_reduce(out, op=dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX, group=_GROUPS[group])
    return out


@tp_all_reduce.register_fake
def _(x, group, op):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


class PsumTP(torch.autograd.Function):
    """All-reduce sum over the model group, forward and backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return tp_all_reduce(x, group, "sum")

    @staticmethod
    def backward(ctx, g):
        return tp_all_reduce(g, ctx.group, "sum"), None


class TPCtx(NamedTuple):
    """The tensor-parallel context threaded through the model code: the
    model group (registered under ``group``), its size ``tp``, this
    process's rank in it, and the compute dtype.  Serving's long-context
    cache layout also names the data group by one (``Model(data_ctx=)``),
    whose ``tp`` is then that group's size."""

    tp: int = 1
    rank: int = 0
    group: str = ""
    compute_dtype: torch.dtype = torch.bfloat16

    @classmethod
    def over(cls, group, compute_dtype: torch.dtype = torch.bfloat16
             ) -> "TPCtx":
        """The context of this process in ``group`` (a process group of
        ``torch.distributed``)."""
        name = f"tp{len(_GROUPS)}"
        _GROUPS[name] = group
        return cls(dist.get_world_size(group), dist.get_rank(group), name,
                   compute_dtype)

    @property
    def process_group(self):
        """The ``torch.distributed`` group this context runs over."""
        return _GROUPS[self.group]

    def tp_rank(self) -> int:
        return self.rank

    def psum_tp(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.tp == 1 else PsumTP.apply(x, self.group)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """The element-wise max over the group, outside autograd (the
        reference all-gathers a stop_gradient value and takes its max)."""
        return x if self.tp == 1 else tp_all_reduce(x.detach(), self.group,
                                                    "max")

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The element-wise sum over the group, outside autograd (serving's
        softmax sums over the sequence shards)."""
        return x if self.tp == 1 else tp_all_reduce(x.detach(), self.group,
                                                    "sum")


TP1 = TPCtx()


def shard_of(ctxs) -> tuple[int, int]:
    """(shards, this rank's shard) of a dim split over the groups of
    ``ctxs`` in order, the first outermost: the reference's ``shard_id =
    shard_id * axis_size(ax) + axis_index(ax)`` over ``seq_shard_axes``
    (on ``launch.mesh.init_grid``'s grid, over (data, model), the world
    rank)."""
    n, i = 1, 0
    for c in ctxs:
        n, i = n * c.tp, i * c.tp + c.rank
    return n, i


def tp_all_gather(ctx: TPCtx, x: torch.Tensor) -> torch.Tensor:
    """x from every rank of the group -> (tp, ...) in rank order (outside
    autograd: checkpoints, serving's q and logits, gathered caches)."""
    if ctx.tp == 1:
        return x[None]
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(ctx.tp)]
    with timing.span("tp_all_gather", device=True):
        timing.count("bytes", x.numel() * x.element_size())
        dist.all_gather(parts, x, group=ctx.process_group)
    return torch.stack(parts)


def pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


class Dims(NamedTuple):
    """TP-padded dimensions of one config: query heads, FFN width and
    vocabulary padded to multiples of tp and sharded; the kv heads are
    replicated (every q head's kv head is then on its rank)."""

    n_heads: int          # padded global query heads
    n_kv_heads: int       # kv heads (replicated; unpadded)
    heads_local: int
    d_ff: int             # padded global
    ff_local: int
    vocab: int            # padded global
    vocab_local: int
    head_dim: int
    tp: int


def make_dims(cfg: ModelConfig, tp: int = 1) -> Dims:
    n_heads = pad_to(cfg.num_heads, tp)
    d_ff = pad_to(cfg.d_ff, tp)
    vocab = pad_to(cfg.vocab_size, tp)
    return Dims(n_heads=n_heads, n_kv_heads=cfg.num_kv_heads,
                heads_local=n_heads // tp, d_ff=d_ff, ff_local=d_ff // tp,
                vocab=vocab, vocab_local=vocab // tp,
                head_dim=cfg.head_dim_, tp=tp)


def head_mask(ctx: TPCtx, cfg: ModelConfig, dims: Dims,
              device=None) -> torch.Tensor:
    """(heads_local,) float32: 1 for this rank's real q heads, 0 for the
    padding heads (their output, and so their weights' gradients, are
    zero)."""
    g = ctx.tp_rank() * dims.heads_local + torch.arange(dims.heads_local,
                                                        device=device)
    return (g < cfg.num_heads).float()


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
           w2: torch.Tensor, ctx: TPCtx = TP1) -> torch.Tensor:
    """SwiGLU FFN; at tp > 1 column- then row-parallel, with one psum."""
    return ctx.psum_tp((F.silu(x @ w1) * (x @ w3)) @ w2)


def embed_lookup(ctx: TPCtx, emb: torch.Tensor, ids: torch.Tensor
                 ) -> torch.Tensor:
    """ids (B, S) -> (B, S, d) rows of the embedding.  At tp > 1 ``emb``
    is this rank's (vocab_local, d) shard: the rows of ids held elsewhere
    are zero, and the ranks' lookups are summed in the compute dtype."""
    if ctx.tp == 1:
        return F.embedding(ids, emb)
    vloc = emb.shape[0]
    local = ids - ctx.tp_rank() * vloc
    inside = (local >= 0) & (local < vloc)
    x = F.embedding(local.clamp(0, vloc - 1), emb)
    x = torch.where(inside[..., None], x, 0.0)
    return ctx.psum_tp(x.to(ctx.compute_dtype))


def _ce_chunk(w: torch.Tensor, x: torch.Tensor, labels: torch.Tensor,
              ctx: TPCtx = TP1, vocab: int = 0) -> torch.Tensor:
    """The cross-entropy summed over one (B, C, d) slice, in float32: the
    reference's ``_ce_chunk`` (the max shift held constant).  At tp > 1
    ``w`` is this rank's (d, vocab_local) shard: columns past ``vocab``
    (the padding) are -inf, the max is taken over the group outside
    autograd, and the softmax sum and the label's logit are psum'd."""
    logits = (x @ w).float()
    if ctx.tp == 1:
        m = torch.amax(logits, dim=-1).detach()
        lse = m + torch.log(torch.sum(torch.exp(logits - m[..., None]),
                                      dim=-1))
        picked = torch.gather(logits, -1, labels[..., None])[..., 0]
        return torch.sum(lse - picked)
    vloc = w.shape[-1]
    start = ctx.tp_rank() * vloc
    col = start + torch.arange(vloc, device=x.device)
    logits = torch.where(col < vocab, logits, -torch.inf)
    m = ctx.pmax(torch.amax(logits, dim=-1))
    se = ctx.psum_tp(torch.sum(torch.exp(logits - m[..., None]), dim=-1))
    lse = m + torch.log(se)
    local = labels - start
    inside = (local >= 0) & (local < vloc)
    picked = torch.gather(logits, -1,
                          local.clamp(0, vloc - 1)[..., None])[..., 0]
    correct = ctx.psum_tp(torch.where(inside, picked, 0.0))
    return torch.sum(lse - correct)


def lm_head_loss(w: torch.Tensor, x: torch.Tensor, labels: torch.Tensor,
                 chunk: int = 512, ctx: TPCtx = TP1, vocab: int = 0
                 ) -> torch.Tensor:
    """Mean softmax cross-entropy; w: (d, V) (at tp > 1 this rank's
    (d, vocab_local) shard of the head, ``vocab`` the unpadded size);
    x: (B, S, d).

    As the reference's: where ``S <= chunk`` or ``S % chunk`` one chunk,
    ``sum(lse - picked) / (B*S)``; otherwise the float32 sums of the
    sequence chunks ``[c*chunk, (c+1)*chunk)`` are added in order and the
    total divided by B*S.  With grad enabled each chunk runs under a
    checkpoint, so that one (B, chunk, V) float32 logits tensor lives at a
    time and the backward recomputes it (its collectives too, in the same
    order on every rank)."""
    B, S, _ = x.shape
    ce = functools.partial(_ce_chunk, ctx=ctx, vocab=vocab)
    if S <= chunk or S % chunk:
        timing.count("chunks")
        return ce(w, x, labels) / (B * S)
    timing.count("chunks", S // chunk)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(0, S, chunk):
        xc, lc = x[:, c:c + chunk], labels[:, c:c + chunk]
        if torch.is_grad_enabled():
            part = checkpoint(ce, w, xc, lc, use_reentrant=False)
        else:
            part = ce(w, xc, lc)
        total = total + part
    return total / (B * S)


def lm_head_logits(w: torch.Tensor, x: torch.Tensor, ctx: TPCtx = TP1,
                   vocab: int = 0) -> torch.Tensor:
    """Serving's logits: the matmul in x's dtype, then float32.
    w: (d, V); x: (B, d) -> (B, V).  At tp > 1 the ranks' vocabulary
    shards are all-gathered and cut to the unpadded ``vocab``."""
    logits = (x @ w).float()
    if ctx.tp == 1:
        return logits
    parts = tp_all_gather(ctx, logits)
    return torch.cat(list(parts), dim=-1)[..., :vocab]

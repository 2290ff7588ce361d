"""The decoder stack, with its parameters in one flat buffer.

Every parameter is a view into ``Model.flat``, a vector of the config's
``param_dtype`` laid out exactly as the reference's
``ravel_pytree(params)`` flattens its parameter tree: dict keys sorted
(upper case before lower case, so Mamba's ``A_log`` and ``D`` come
first, and ``cross`` before ``cross_norm``), ``slots`` a list of
``group_size`` layer slots, and each slot's leaves stacked over the
groups as ``(num_groups, tp=1, ...)``, so all groups' ``w1`` of a slot
come before their ``w2``.  Bucket membership, and with it every norm and
code on the wire, depends on this order.

Because the parameters alias the buffer, the flat vector needs no copy:
``attach_grads(g)`` points every parameter's ``.grad`` at its slice of a
flat gradient row ``g``, and a backward pass then accumulates the
worker's gradient straight into ``g`` (autograd adds into a defined
``.grad`` in place).

Activation rematerialization (``Model(remat=...)``, the reference's
``"full"`` by default) acts on the training forward with grad enabled:
each layer group runs under a non-reentrant checkpoint and, under
``"full"`` with several slots a group, each slot under one more, so that
a backward holds one group's (one slot's) activations at a time;
``"dots"`` keeps the matmul outputs and recomputes the rest, ``"psum"``
keeps the outputs of the model group's all-reduces (``psum_tp``) and
recomputes the rest, so that a recomputation replays no collective (at
tp = 1, where there is none, it is one plain checkpoint a group).

Tensor parallelism (``Model(tp_ctx=...)``, tp > 1) keeps the layout a
rank of the reference's (data, model) mesh sees: each rank's flat holds
its own shards, ``param_layout(cfg, tp)`` (heads, FFN columns, experts,
RWKV heads and Mamba channels sharded, the vocabulary of ``embed`` and
``lm_head`` sharded, the kv projections, norms, router and RWKV's decay
LoRA and mixing factors replicated), with the mesh axis of extent 1 that
``ravel_pytree`` sees inside ``shard_map``, so that every bucket on the
wire holds what it holds in the reference.  ``to_global`` and
``from_global`` convert the ranks' flats to and from the reference's
global layout, where every sharded leaf is stacked over the tp axis.
An MoE layer with ``cfg.experts_held`` (at tp = 1) lays out the card's
block of experts, as a rank of an expert-parallel group does
(``moe.moe_factor``).
The replicated leaves are drawn rank-invariantly (``REPLICATED_LEAVES``);
they train on rank-local gradients, as in the reference (see
``layers``), and may drift apart across the model group.  A
checkpoint's recomputation replays the forward's collectives, in the same
order on every rank.

``param_mode="fsdp"`` keeps the parameters in the reference's FSDP
layout instead: each layer slot's leaves are one zero-padded flat vector
a group (``fsdp_layout``), sharded over the M data-parallel workers, and
``embed`` and ``lm_head`` each have their own padded flat; ``final_norm``
is replicated.  ``Model.flat`` then holds the local workers' shards,
(entry, local worker) after one another, and a layer's weights are views
into the gathered vector of its slot (``dist.fsdp.make_gather``), which
the checkpointed group body gathers again in the backward.

While a step is being recorded (``repro_torch.timing``) the training
forward opens ``embed`` and ``loss`` spans (with the chunked loss's
``chunks``), and the recorder's forward hooks on ``layers`` give each
slot's ``block`` span, or ``recompute`` where the checkpoint replays it
inside a backward; the model takes no clock.

Serving runs the same layers in another mode (``PREFILL``: the sequence
forward that also returns each mixer's decode cache; ``DECODE``: one
token a row against those caches), without autograd.  Caches keep the
reference's layout: a list with one entry per layer slot, each a tuple
of tensors stacked over the groups as (num_groups, B, ...).  A rank
holds its shard of each (``cache_layout``): attention's ring is
sequence-sharded over the groups of ``seq_shard_axes`` (the model group;
for batch-1 long context the data group, then the model group), RWKV6's
states over the model group by heads and Mamba's by channels, and the
batch over the data group where the serve launcher splits it.
``gather_caches`` and ``shard_caches`` move between a rank's caches and
the global ones (the reference's ``shard_map`` outputs).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts)

import numpy as np

from .attention import (attn_decode, attn_forward, cache_spec,
                        cross_attn_forward)
from .config import MAMBA, RWKV, ModelConfig
from .layers import (TP1, TPCtx, embed_lookup, lm_head_logits, lm_head_loss,
                     make_dims, rms_norm, shard_of, swiglu, tp_all_gather,
                     tp_all_reduce)
from .mamba import A_LOG_INIT, mamba_dims, mamba_forward, mamba_specs
from .moe import moe_factor, moe_ffn
from .rwkv import rwkv_decode, rwkv_dims, rwkv_forward, rwkv_specs
from repro_torch import timing
from repro_torch.core.codec import codec_for_scheme
from repro_torch.core.schemes import QuantScheme
from repro_torch.dist.fsdp import (
    SeedKey, flatten_meta, make_gather, padded_flat_len, unflatten)
from repro_torch.dist.transport import StackedTransport

# init codes: -1 ones (norm weights), 0 zeros (biases and the cross gate),
# A_LOG_INIT (-2) Mamba's log(1..d_state), > 0 normal * in_dim ** -0.5
_ONES = -1
_ZEROS = 0

# what a layer runs: the training forward, serving's prefill (the same
# forward, also returning the caches) or one decode step
TRAIN, PREFILL, DECODE = "train", "prefill", "decode"

REMAT_MODES = ("full", "dots", "psum", "none")
# "dots" keeps the outputs of these (the reference's checkpoint_dots)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)
# the key folds of the FSDP gathers: slot s folds s, embed and lm_head these
EMBED_FOLD, LM_FOLD = 1001, 1002


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


_dots_context = functools.partial(create_selective_checkpoint_contexts,
                                  _dots_policy)


def _psum_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE
            if op is torch.ops.repro_torch.tp_all_reduce.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


_psum_context = functools.partial(create_selective_checkpoint_contexts,
                                  _psum_policy)

# leaves every rank of the model group holds whole; they are drawn the same
# on every rank (the reference's REPLICATED_LEAVES)
REPLICATED_LEAVES = {"wk", "wv", "bk", "bv", "router", "w_lora_a",
                     "w_lora_b", "w0", "mu_r", "mu_k", "mu_v", "mu_g",
                     "mu_w"}


def _slot_specs(cfg: ModelConfig, slot: int, tp: int = 1
                ) -> dict[str, tuple[tuple, int]]:
    """leaf path within layer slot ``slot`` -> (one rank's per-layer
    shape, init code), the reference's ``slot_param_specs``: the norms,
    the mixer (attention, the RWKV6 time-mix or Mamba), the
    cross-attention block on a VLM's cross slots, and the FFN (SwiGLU or
    MoE)."""
    dims = make_dims(cfg, tp)
    d, ff, hd = cfg.d_model, cfg.d_ff, cfg.head_dim_
    nq, nkv = dims.heads_local * hd, cfg.num_kv_heads * hd
    wo_in = dims.n_heads * hd
    specs = {"norm1": ((d,), _ONES), "norm2": ((d,), _ONES)}
    kind = cfg.slot_kind(slot)
    if kind == RWKV:
        specs.update({f"mixer.{k}": v
                      for k, v in rwkv_specs(cfg, tp).items()})
    elif kind == MAMBA:
        specs.update({f"mixer.{k}": v
                      for k, v in mamba_specs(cfg, tp).items()})
    else:
        specs.update({"mixer.wk": ((d, nkv), d),
                      "mixer.wo": ((nq, d), wo_in),
                      "mixer.wq": ((d, nq), d),
                      "mixer.wv": ((d, nkv), d)})
        if cfg.qkv_bias:
            specs.update({"mixer.bq": ((nq,), _ZEROS),
                          "mixer.bk": ((nkv,), _ZEROS),
                          "mixer.bv": ((nkv,), _ZEROS)})
        if cfg.qk_norm:
            specs.update({"mixer.q_norm": ((hd,), _ONES),
                          "mixer.k_norm": ((hd,), _ONES)})
    if cfg.slot_has_cross(slot):
        specs.update({"cross_norm": ((d,), _ONES),
                      "cross.gate": ((1,), _ZEROS),
                      "cross.wk": ((d, nkv), d),
                      "cross.wo": ((nq, d), wo_in),
                      "cross.wq": ((d, nq), d),
                      "cross.wv": ((d, nkv), d)})
    if cfg.slot_is_moe(slot):
        E = cfg.num_experts
        ep, fp = moe_factor(cfg, tp)
        El, ffl = E // ep, -(-ff // fp)
        specs.update({"ffn.router": ((d, E), d),
                      "ffn.w1": ((El, d, ffl), d),
                      "ffn.w2": ((El, ffl, d), ff),
                      "ffn.w3": ((El, d, ffl), d)})
        if cfg.shared_expert:
            fl = dims.ff_local
            specs.update({"ffn.sw1": ((d, fl), d),
                          "ffn.sw2": ((fl, d), ff),
                          "ffn.sw3": ((d, fl), d)})
    else:
        fl = dims.ff_local
        specs.update({"ffn.w1": ((d, fl), d),
                      "ffn.w2": ((fl, d), dims.d_ff),
                      "ffn.w3": ((d, fl), d)})
    return specs


def slot_layout(cfg: ModelConfig, slot: int, tp: int = 1
                ) -> list[tuple[str, tuple, int]]:
    """(leaf path, one rank's per-layer shape, init code) of layer slot
    ``slot``, in the order of sorted nested keys (a block's leaves
    together)."""
    specs = _slot_specs(cfg, slot, tp)
    return [(path, *specs[path])
            for path in sorted(specs, key=lambda p: p.split("."))]


def param_layout(cfg: ModelConfig, tp: int = 1
                 ) -> list[tuple[str, tuple, int]]:
    """(name, shape, init code) of every leaf of one rank of a model
    group of ``tp``, in flat (ravel) order: ``embed`` (1, vocab_local,
    d), ``final_norm``, ``lm_head`` (1, d, vocab_local), then ``slots``,
    a list of ``group_size`` dicts whose leaves are stacked as
    (num_groups, 1, ...), each with its keys sorted.  The axes of extent
    1 are the reference's tp axis (``tp_axis``)."""
    d, G = cfg.d_model, cfg.num_groups
    V = make_dims(cfg, tp).vocab_local
    layout = [("embed", (1, V, d), d), ("final_norm", (d,), _ONES),
              ("lm_head", (1, d, V), d)]
    for slot in range(cfg.group_size):
        layout += [(f"slots.{slot}.{path}", (G, 1, *shape), code)
                   for path, shape, code in slot_layout(cfg, slot, tp)]
    return layout


def tp_axis(name: str) -> int | None:
    """The axis of leaf (or FSDP flat) ``name`` that the reference stacks
    its ranks' shards along: 0 for ``embed`` and ``lm_head``, 1 for a
    slot's (after the groups'), None for the replicated ``final_norm``."""
    if name == "final_norm":
        return None
    return 1 if name.startswith("slots.") else 0


def _pieces(cfg: ModelConfig, tp: int, fsdp: tuple[int, int] | None
            ) -> list[tuple[str, tuple]]:
    """(name, one rank's shape with the tp axis of extent 1) of every
    leaf of the DP layout, or with ``fsdp`` = (bucket_size, M) of every
    flat of the global FSDP layout, in order."""
    if fsdp is None:
        return [(name, shape) for name, shape, _ in param_layout(cfg, tp)]
    return [(e.name, (e.Lp,) if e.meta is None else
             (e.count, 1, e.Lp) if e.name.startswith("slots.") else
             (1, e.Lp)) for e in fsdp_layout(cfg, *fsdp, tp)]


def to_global(flats: torch.Tensor, cfg: ModelConfig, *,
              fsdp: tuple[int, int] | None = None) -> torch.Tensor:
    """The tp ranks' flats (tp, n), each in ``param_layout(cfg, tp)``'s
    order (or with ``fsdp`` = (bucket_size, M) the global FSDP layout's)
    -> the reference's global flat: every leaf with its ranks' shards
    stacked along its tp axis, ``final_norm`` rank 0's (the reference's
    replicated out-spec gives device 0's)."""
    tp = flats.shape[0]
    out, off = [], 0
    for name, shape in _pieces(cfg, tp, fsdp):
        n = math.prod(shape)
        views = [f[off:off + n].view(shape) for f in flats]
        ax = tp_axis(name)
        out.append((views[0] if ax is None
                    else torch.cat(views, dim=ax)).reshape(-1))
        off += n
    if off != flats.shape[1]:
        raise ValueError(f"flats of {flats.shape[1]} for a layout of {off}")
    return torch.cat(out)


def final_norm_slice(cfg: ModelConfig, tp: int, *,
                     fsdp: tuple[int, int] | None = None) -> slice:
    """Where ``final_norm`` lies in one rank's flat (``to_global``'s
    layouts)."""
    off = 0
    for name, shape in _pieces(cfg, tp, fsdp):
        if name == "final_norm":
            return slice(off, off + shape[0])
        off += math.prod(shape)
    raise KeyError("final_norm")


def global_pieces(cfg: ModelConfig, tp: int,
                  fsdp: tuple[int, int] | None = None
                  ) -> list[tuple[str, tuple, int | None]]:
    """(name, global shape, tp axis) of every piece of ``to_global``'s
    layout, in order: the tp axis of extent ``tp``, None where the leaf
    is replicated."""
    out = []
    for name, shape in _pieces(cfg, tp, fsdp):
        ax = tp_axis(name)
        full = list(shape)
        if ax is not None:
            full[ax] = tp
        out.append((name, tuple(full), ax))
    return out


def from_global(gflat: torch.Tensor, cfg: ModelConfig, tp: int, rank: int,
                *, fsdp: tuple[int, int] | None = None) -> torch.Tensor:
    """The inverse of ``to_global`` for rank ``rank`` of ``tp``."""
    out, off = [], 0
    for name, full, ax in global_pieces(cfg, tp, fsdp):
        n = math.prod(full)
        view = gflat[off:off + n].view(full)
        if ax is not None:
            view = view.narrow(ax, rank, 1)
        out.append(view.reshape(-1))
        off += n
    if off != gflat.numel():
        raise ValueError(f"a global flat of {gflat.numel()} for a layout "
                         f"of {off}")
    return torch.cat(out)


def slot_meta(cfg: ModelConfig, slot: int, tp: int = 1) -> list:
    """The reference's ``flatten_meta(slot_param_specs(...))`` of layer
    slot ``slot`` on one rank of ``tp``: [(path tuple, per-layer shape,
    init code)]."""
    nested: dict = {}
    for path, shape, code in slot_layout(cfg, slot, tp):
        *head, leaf = path.split(".")
        node = nested
        for h in head:
            node = node.setdefault(h, {})
        node[leaf] = (shape, code)
    return flatten_meta(nested)


class FsdpEntry(NamedTuple):
    """One flat of the FSDP layout: ``count`` padded vectors of ``Lp``
    (a slot's: one a group), sharded over the workers, or the replicated
    ``final_norm`` (``Lp`` = d, ``meta`` None)."""

    name: str           # embed | final_norm | lm_head | slots.<s>
    count: int
    Lp: int
    meta: list | None
    fold: int | None    # the gather's key fold


def fsdp_layout(cfg: ModelConfig, bucket_size: int, M: int, tp: int = 1
                ) -> list[FsdpEntry]:
    """The reference's FSDP parameter tree of one rank of a model group
    of ``tp`` in its ravel order (``embed``, ``final_norm``, ``lm_head``,
    ``slots``), each flat padded to ``padded_flat_len(meta, bucket_size,
    M, M)``."""
    d, V = cfg.d_model, make_dims(cfg, tp).vocab_local
    emb = [(("embed",), (V, d), d)]
    lm = [(("lm_head",), (d, V), d)]
    out = [FsdpEntry("embed", 1, padded_flat_len(emb, bucket_size, M, M),
                     emb, EMBED_FOLD),
           FsdpEntry("final_norm", 1, d, None, None),
           FsdpEntry("lm_head", 1, padded_flat_len(lm, bucket_size, M, M),
                     lm, LM_FOLD)]
    for s in range(cfg.group_size):
        meta = slot_meta(cfg, s, tp)
        out.append(FsdpEntry(f"slots.{s}", cfg.num_groups,
                             padded_flat_len(meta, bucket_size, M, M),
                             meta, s))
    return out


def fsdp_views(buf: torch.Tensor, entries: list[FsdpEntry], M: int,
               L: int) -> dict[str, torch.Tensor]:
    """Views of a buffer holding L workers' shards of every entry: a
    sharded entry (count, L, Lp/M), ``final_norm`` (d,).  With L = M the
    buffer is the whole (global) layout, each entry (count, Lp)."""
    out, off = {}, 0
    for e in entries:
        if e.meta is None:
            out[e.name] = buf[off:off + e.Lp]
            off += e.Lp
            continue
        n = e.count * L * (e.Lp // M)
        out[e.name] = buf[off:off + n].view(e.count, L, e.Lp // M)
        off += n
    if off != buf.numel():
        raise ValueError(f"buffer of {buf.numel()} for a layout of {off}")
    return out


def fsdp_size(entries: list[FsdpEntry], M: int, L: int) -> int:
    return sum(e.Lp if e.meta is None else e.count * L * (e.Lp // M)
               for e in entries)


def dp_to_fsdp(flat: torch.Tensor, cfg: ModelConfig, bucket_size: int,
               M: int, tp: int = 1) -> torch.Tensor:
    """A DP flat (``param_layout``'s ravel order) -> the global FSDP flat
    of M workers and buckets of ``bucket_size`` (the reference's FSDP tree
    in ravel order), both of one rank of a model group of ``tp``."""
    entries = fsdp_layout(cfg, bucket_size, M, tp)
    views, off = {}, 0
    for name, shape, _ in param_layout(cfg, tp):
        n = math.prod(shape)
        views[name] = flat[off:off + n].view(shape)
        off += n
    parts = []
    for e in entries:
        if e.meta is None:
            parts.append(views[e.name].reshape(1, -1))
            continue
        if not e.name.startswith("slots."):
            leaves = [views[e.name].reshape(1, -1)]
        else:
            leaves = [views[f"{e.name}.{'.'.join(path)}"].reshape(
                e.count, -1) for path, _, _ in e.meta]
        body = torch.cat(leaves, dim=1)
        parts.append(F.pad(body, (0, e.Lp - body.shape[1])))
    return torch.cat([p.reshape(-1) for p in parts])


def fsdp_to_dp(gflat: torch.Tensor, cfg: ModelConfig, bucket_size: int,
               M: int, tp: int = 1) -> torch.Tensor:
    """The inverse of ``dp_to_fsdp``: the global FSDP flat -> a DP flat
    (the padding dropped)."""
    entries = fsdp_layout(cfg, bucket_size, M, tp)
    views = fsdp_views(gflat, entries, M, M)
    leaves = {}
    for e in entries:
        if e.meta is None:
            leaves[e.name] = views[e.name]
            continue
        body = views[e.name].reshape(e.count, e.Lp)
        off = 0
        for path, shape, _ in e.meta:
            n = math.prod(shape)
            key = (f"{e.name}.{'.'.join(path)}"
                   if e.name.startswith("slots.") else e.name)
            leaves[key] = body[:, off:off + n]
            off += n
    return torch.cat([leaves[name].reshape(-1)
                      for name, _, _ in param_layout(cfg, tp)])


def rank_seed(seed: int, rank: int) -> int:
    """The seed of model rank ``rank``'s sharded leaves."""
    ss = np.random.SeedSequence([seed, 0x7E50, rank])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def init_flat(layout, dtype: torch.dtype, device, seed: int,
              rank: int | None = None
              ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """A flat buffer for ``layout`` ((name, shape, init code) triples)
    and a view of it per name, drawn by init code with a
    ``torch.Generator`` on ``device`` seeded ``seed``.  With ``rank``
    (a rank of a model group) the replicated leaves come from that
    generator in order, the same on every rank, and the others from one
    seeded ``rank_seed(seed, rank)``."""
    flat = torch.empty(sum(math.prod(shape) for _, shape, _ in layout),
                       dtype=dtype, device=device)
    # the meta device holds shapes and no generator: nothing is drawn
    draw = flat.device.type != "meta"
    if draw:
        gen = torch.Generator(device=flat.device).manual_seed(seed)
        own = gen if rank is None else torch.Generator(
            device=flat.device).manual_seed(rank_seed(seed, rank))
    views, off = {}, 0
    for name, shape, code in layout:
        n = math.prod(shape)
        view = flat[off:off + n].view(shape)
        if not draw:
            pass
        elif code == _ONES:
            view.fill_(1.0)
        elif code == A_LOG_INIT:
            view.copy_(torch.log(torch.arange(
                1, shape[-1] + 1, dtype=torch.float32, device=flat.device)))
        elif code == _ZEROS:
            view.zero_()
        else:
            leaf = name.rsplit(".", 1)[-1]
            view.normal_(generator=gen if leaf in REPLICATED_LEAVES
                         else own).mul_(code ** -0.5)
        views[name] = view
        off += n
    return flat, views


def attach_grads(module: nn.Module, flat: torch.Tensor,
                 grad_flat: torch.Tensor) -> None:
    """Point the ``.grad`` of each parameter of ``module``, a view of
    ``flat``, at its slice of ``grad_flat`` (``flat``'s shape and
    dtype)."""
    if grad_flat.dtype != flat.dtype:
        raise ValueError(f"gradient {grad_flat.dtype} for parameters "
                         f"{flat.dtype}")
    base, size = flat.data_ptr(), flat.element_size()
    for p in module.parameters():
        off = (p.data_ptr() - base) // size
        p.grad = grad_flat[off:off + p.numel()].view(p.shape)


class DecoderLayer(nn.Module):
    """Pre-norm block of one layer slot: a mixer (attention of the slot's
    ``attn_kind``, the RWKV6 time-mix or Mamba), on a cross slot the
    gated cross-attention to the image embeddings, and an FFN (SwiGLU,
    or MoE).  ``leaves`` maps the slot's leaf paths (``norm1``,
    ``mixer.wq``, ``cross.gate``, ``ffn.w1``, ...) to views into the flat
    buffer."""

    def __init__(self, cfg: ModelConfig,
                 leaves: dict[str, torch.Tensor] | None, slot: int,
                 ctx: TPCtx = TP1):
        super().__init__()
        self.cfg = cfg
        self.ctx = ctx
        self.kind = cfg.slot_kind(slot)
        self.attn_kind = cfg.slot_attn_kind(slot)
        self.is_moe = cfg.slot_is_moe(slot)
        self.has_cross = cfg.slot_has_cross(slot)
        if leaves is None:      # FSDP: the weights come with each call
            return
        self.norm1 = nn.Parameter(leaves["norm1"])
        self.norm2 = nn.Parameter(leaves["norm2"])
        if self.has_cross:
            self.cross_norm = nn.Parameter(leaves["cross_norm"])
        self.mixer = nn.ParameterDict()
        self.cross = nn.ParameterDict()
        self.ffn = nn.ParameterDict()
        for path, view in leaves.items():
            group, _, name = path.partition(".")
            if name:
                getattr(self, group)[name] = nn.Parameter(view)

    def _own_weights(self) -> dict:
        out = {"norm1": self.norm1, "norm2": self.norm2,
               "mixer": dict(self.mixer), "cross": dict(self.cross),
               "ffn": dict(self.ffn)}
        if self.has_cross:
            out["cross_norm"] = self.cross_norm
        return out

    def forward(self, x: torch.Tensor, vision: torch.Tensor | None = None,
                mode: str = TRAIN, cache: tuple | None = None,
                pos: torch.Tensor | None = None, max_len: int = 0,
                weights: dict | None = None, cache_shards: int = 1,
                seq_ctxs=()) -> tuple[torch.Tensor, torch.Tensor,
                                      tuple | None]:
        """x: (B, S, d) -> (x, the MoE aux loss or 0, the mixer's cache or
        None).  ``mode``: ``TRAIN``; ``PREFILL``, which also returns the
        decode cache (attention's of ``max_len`` slots at most); or
        ``DECODE``, one token a row (S = 1) at positions ``pos`` (B,)
        against ``cache``.  Attention's cache is this rank's of
        ``cache_shards`` sequence shards over the groups of ``seq_ctxs``.
        A cross slot runs its cross-attention block only when ``vision``
        is given.  ``weights`` (the slot's leaves, nested as
        ``dist.fsdp.unflatten`` gives them) replaces the layer's own
        parameters (FSDP's gathered slot)."""
        cfg, cd, ctx = self.cfg, x.dtype, self.ctx
        w = self._own_weights() if weights is None else weights

        def block(group):
            return {k: v.to(cd) for k, v in w.get(group, {}).items()}

        mixer = block("mixer")
        h = rms_norm(x, w["norm1"].to(cd), cfg.norm_eps)
        prefill = mode == PREFILL
        shards = dict(cache_shards=cache_shards, seq_ctxs=seq_ctxs)
        if self.kind == RWKV:
            out = (rwkv_decode(cfg, mixer, h, cache, ctx) if mode == DECODE
                   else rwkv_forward(cfg, mixer, h, return_state=prefill,
                                     ctx=ctx))
        elif self.kind == MAMBA:        # decode: the forward on one token
            out = mamba_forward(cfg, mixer, h, cache=cache,
                                return_state=mode != TRAIN, ctx=ctx)
        elif mode == DECODE:
            out = attn_decode(cfg, mixer, h, pos, cache, self.attn_kind,
                              ctx=ctx, **shards)
        else:
            out = attn_forward(cfg, mixer, h, self.attn_kind,
                               return_cache=prefill, max_len=max_len,
                               ctx=ctx, **shards)
        mix, cache = (out, None) if mode == TRAIN else out
        x = x + mix.to(cd)
        if self.has_cross and vision is not None:
            cross = block("cross")
            h = rms_norm(x, w["cross_norm"].to(cd), cfg.norm_eps)
            x = x + cross_attn_forward(cfg, cross, h, vision, ctx).to(cd)
        ffn = block("ffn")
        h = rms_norm(x, w["norm2"].to(cd), cfg.norm_eps)
        if self.is_moe:
            y, aux = moe_ffn(cfg, ffn, h, ctx)
        else:
            y, aux = swiglu(h, ffn["w1"], ffn["w3"], ffn["w2"], ctx), 0.0
        return x + y, aux, cache


class Model(nn.Module):
    """Decoder whose parameters live in one flat buffer of the config's
    ``param_dtype``.

    ``seed`` draws the weights with a ``torch.Generator`` on ``device``
    (normal * in_dim ** -0.5, norm weights 1, Mamba's A_log
    log(1..d_state)); ``load_flat`` replaces them, e.g. with weights
    carried over from the reference (``repro_torch.weights``).

    ``remat``: ``"full"`` (the reference's default), ``"dots"``,
    ``"psum"`` or ``"none"`` (see the module's docstring).

    ``param_mode="fsdp"`` stores the parameters sharded over the workers
    of ``transport`` (a ``StackedTransport`` of ``dp`` by default); the
    gathers' backward reduce-scatters the gradient to the worker mean,
    quantized with ``fsdp_codec`` (the scheme's uniform codec by default)
    when ``fsdp_sync == "quantized"`` and ``fsdp_scheme`` quantizes, else
    in float32.  The same ``seed`` draws the same weights in both modes.

    ``tp_ctx`` (a ``TPCtx`` over a model group, ``layers.TPCtx.over``)
    makes this the model's rank ``tp_ctx.rank`` of ``tp`` (tp > 1): its
    flat holds that rank's shards (``param_layout(cfg, tp)``), drawn per
    rank but for the replicated leaves, and the forward issues the
    group's collectives.  Under FSDP each model rank shards its own flat
    over the data-parallel ``transport``.

    Serving's attention caches are sequence-sharded over the groups of
    ``seq_shard_axes``, "model" (``tp_ctx``'s group) and "data"
    (``data_ctx``'s, a ``TPCtx`` over this rank's data group, which
    ``launch.mesh.init_grid`` gives); the reference's default is
    ("model",), and ("data", "model") shards a batch-1 long-context cache
    over every rank of the grid.
    """

    def __init__(self, cfg: ModelConfig, *, device="cuda", seed: int = 0,
                 remat: str = "full", param_mode: str = "dp", dp: int = 1,
                 transport: StackedTransport | None = None,
                 fsdp_scheme: QuantScheme | None = None,
                 fsdp_sync: str = "quantized", fsdp_codec=None,
                 tp_ctx: TPCtx | None = None, data_ctx: TPCtx | None = None,
                 seq_shard_axes: tuple[str, ...] = ("model",)):
        super().__init__()
        if remat not in REMAT_MODES:
            raise ValueError(f"remat {remat!r}; known: {REMAT_MODES}")
        if param_mode not in ("dp", "fsdp"):
            raise ValueError(f"param_mode {param_mode!r}")
        tp_ctx = TP1 if tp_ctx is None else tp_ctx
        self.cfg = cfg
        self.remat = remat
        self.param_mode = param_mode
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        self.ctx = tp_ctx._replace(compute_dtype=self.compute_dtype)
        self.tp = self.ctx.tp
        self.dims = make_dims(cfg, self.tp)
        # the groups a cache dim may be split over, by the reference's axis
        self.groups = {"model": self.ctx, "data": data_ctx or TP1}
        self.seq_shard_axes = tuple(seq_shard_axes)
        self.seq_ctxs = tuple(self.groups[ax] for ax in self.seq_shard_axes)
        flat, lv = init_flat(param_layout(cfg, self.tp),
                             getattr(torch, cfg.param_dtype), device, seed,
                             None if self.tp == 1 else self.ctx.rank)
        if param_mode == "fsdp":
            self._init_fsdp(flat, dp, transport, fsdp_scheme, fsdp_sync,
                            fsdp_codec)
            return
        self.flat = flat
        self.d = self.flat.numel()
        self.embed = nn.Parameter(lv["embed"][0])
        self.lm_head = nn.Parameter(lv["lm_head"][0])
        self.final_norm = nn.Parameter(lv["final_norm"])
        # layer g * group_size + s is slot s of group g
        layers = []
        for g in range(cfg.num_groups):
            for slot in range(cfg.group_size):
                pre = f"slots.{slot}."
                leaves = {name[len(pre):]: view[g, 0]
                          for name, view in lv.items()
                          if name.startswith(pre)}
                layers.append(DecoderLayer(cfg, leaves, slot, self.ctx))
        self.layers = nn.ModuleList(layers)

    def _init_fsdp(self, flat, dp, transport, scheme, fsdp_sync, codec):
        cfg = self.cfg
        if transport is None:
            transport = StackedTransport(dp)
        elif dp not in (1, transport.size()):
            raise ValueError(f"dp={dp} for a transport of "
                             f"{transport.size()} workers")
        self.transport = transport
        self.local = transport.local_workers()
        M, L = transport.size(), len(self.local)
        scheme = scheme or QuantScheme(name="fp32")
        self.fsdp_scheme = scheme
        self.fsdp_sync = fsdp_sync
        self.fsdp_quantized = fsdp_sync == "quantized" and scheme.quantized
        # the codec that rides the backward wire (the metrics report it)
        self.fsdp_codec = codec if codec is not None else codec_for_scheme(
            scheme)
        self._gather = make_gather(scheme, fsdp_sync, transport=transport,
                                   codec=self.fsdp_codec)
        self.fsdp_entries = fsdp_layout(cfg, scheme.bucket_size, M, self.tp)
        self._slot_meta = [e.meta for e in self.fsdp_entries
                           if e.name.startswith("slots.")]
        self.flat = self.local_rows(dp_to_fsdp(flat, cfg, scheme.bucket_size,
                                               M, self.tp))
        del flat
        self.d = self.flat.numel()
        views = fsdp_views(self.flat, self.fsdp_entries, M, L)
        self.embed_shard = nn.Parameter(views["embed"][0])
        self.lm_shard = nn.Parameter(views["lm_head"][0])
        self.final_norm = nn.Parameter(views["final_norm"])
        G = cfg.group_size
        self.slot_shards = nn.ParameterList(
            nn.Parameter(views[f"slots.{s}"][g])
            for g in range(cfg.num_groups) for s in range(G))
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, None, s, self.ctx)
            for _ in range(cfg.num_groups) for s in range(G))
        self._dummy_ctx = (scheme.init_state(self.flat.device).levels,
                           SeedKey(0))

    # ---- the FSDP layout ---------------------------------------------------

    def local_rows(self, gflat: torch.Tensor,
                   workers: list[int] | None = None) -> torch.Tensor:
        """A global FSDP-layout tensor -> the buffer of ``workers``'
        shards (this process's local workers by default)."""
        M = self.transport.size()
        workers = self.local if workers is None else workers
        if list(workers) == list(range(M)):
            return gflat.contiguous()
        views = fsdp_views(gflat, self.fsdp_entries, M, M)
        idx = torch.tensor(workers, device=gflat.device)
        return torch.cat([
            v.reshape(-1) if e.meta is None else
            v.index_select(1, idx).reshape(-1)
            for e, v in zip(self.fsdp_entries, views.values())])

    def global_flat(self, local: torch.Tensor | None = None
                    ) -> torch.Tensor:
        """The local workers' buffer (``self.flat`` by default) -> the
        global FSDP layout: a collective when other processes hold
        workers, so every process calls it."""
        local = self.flat.detach() if local is None else local
        M, L = self.transport.size(), len(self.local)
        if L == M:
            return local
        rows = self.transport.all_gather([local])      # (M, local size)
        out = []
        for e in self.fsdp_entries:
            n = e.Lp if e.meta is None else e.count * (e.Lp // M)
            part, rows = rows[:, :n], rows[:, n:]
            out.append(part[0] if e.meta is None else part.view(
                M, e.count, e.Lp // M).transpose(0, 1).reshape(-1))
        return torch.cat(out)

    # ---- weights ---------------------------------------------------------

    def load_flat(self, flat: torch.Tensor) -> None:
        """Copy a flat parameter vector into the buffer: the ravel-ordered
        DP flat, or under FSDP the global FSDP flat (whose local shards
        are kept)."""
        if self.param_mode == "fsdp":
            size = fsdp_size(self.fsdp_entries, self.transport.size(),
                             self.transport.size())
            if flat.numel() != size:
                raise ValueError(f"FSDP params {tuple(flat.shape)} != "
                                 f"({size},)")
            self.flat.copy_(self.local_rows(flat.to(self.flat.device)))
            return
        if flat.shape != self.flat.shape:
            raise ValueError(f"flat params {tuple(flat.shape)} != "
                             f"({self.d},)")
        self.flat.copy_(flat)

    def attach_grads(self, grad_flat: torch.Tensor) -> None:
        """Point every parameter's ``.grad`` at its slice of
        ``grad_flat`` (d,), which the next backward accumulates into."""
        attach_grads(self, self.flat, grad_flat)

    def _ctx(self, sync_ctx):
        return self._dummy_ctx if sync_ctx is None else sync_ctx

    def _embed_weights(self, sync_ctx) -> torch.Tensor:
        cd = self.compute_dtype
        if self.param_mode != "fsdp":
            return self.embed.to(cd)
        levels, key = self._ctx(sync_ctx)
        full = self._gather(self.embed_shard, levels, key.fold(EMBED_FOLD))
        V, d = self.dims.vocab_local, self.cfg.d_model
        return full[:V * d].view(V, d).to(cd)

    def _lm_weights(self, sync_ctx) -> torch.Tensor:
        cd = self.compute_dtype
        if self.param_mode != "fsdp":
            return self.lm_head.to(cd)
        levels, key = self._ctx(sync_ctx)
        full = self._gather(self.lm_shard, levels, key.fold(LM_FOLD))
        V, d = self.dims.vocab_local, self.cfg.d_model
        return full[:V * d].view(d, V).to(cd)

    def _slot_weights(self, i: int, sync_ctx) -> dict | None:
        """Layer i's weights: None (its own parameters) in DP mode, else
        its slot's gathered flat as leaf views in the compute dtype."""
        if self.param_mode != "fsdp":
            return None
        s = i % self.cfg.group_size
        levels, key = self._ctx(sync_ctx)
        full = self._gather(self.slot_shards[i], levels, key.fold(s))
        return unflatten(full, self._slot_meta[s], self.compute_dtype)

    # ---- the training forward ---------------------------------------------

    def _run_stack(self, x, vision, sync_ctx):
        """The layers over their groups, with the rematerialization of
        ``self.remat`` when grad is enabled: (x, the aux losses summed)."""
        cfg, G = self.cfg, self.cfg.group_size
        remat = self.remat if torch.is_grad_enabled() else "none"
        nested = remat == "full" and G > 1

        def slot_fn(i):
            def run(x):
                x, a, _ = self.layers[i](
                    x, vision, weights=self._slot_weights(i, sync_ctx))
                return x, a
            return run

        psum_mode = remat == "psum" and self.tp > 1

        def body(g):
            def run(x, aux):
                for i in range(g * G, (g + 1) * G):
                    f = slot_fn(i)
                    # bound the group's backward to one slot at a time
                    x, a = (checkpoint(f, x, use_reentrant=False) if nested
                            else f(x))
                    aux = aux + a
                return x, aux
            return run

        aux = 0.0
        for g in range(cfg.num_groups):
            f = body(g)
            if remat == "none":
                x, aux = f(x, aux)
            elif remat == "dots":
                x, aux = checkpoint(f, x, aux, use_reentrant=False,
                                    context_fn=_dots_context)
            elif psum_mode:
                x, aux = checkpoint(f, x, aux, use_reentrant=False,
                                    context_fn=_psum_context)
            else:
                x, aux = checkpoint(f, x, aux, use_reentrant=False)
        return x, aux

    def forward(self, ids: torch.Tensor, vision: torch.Tensor | None = None,
                sync_ctx=None) -> tuple[torch.Tensor, torch.Tensor]:
        """The training forward of a (B, S) batch: (the hidden states after
        the final norm (B, S, d), the MoE layers' aux losses summed).
        ``vision``: (B, S_img, d_model) image embeddings for the VLM's
        cross slots (without them those blocks are skipped).
        ``sync_ctx`` = (levels, key) routes FSDP's reduce-scatters."""
        cd = self.compute_dtype
        with timing.span("embed"):
            x = embed_lookup(self.ctx, self._embed_weights(sync_ctx), ids)
        x, aux = self._run_stack(x, vision, sync_ctx)
        return rms_norm(x, self.final_norm.to(cd), self.cfg.norm_eps), aux

    def loss(self, ids: torch.Tensor, labels: torch.Tensor,
             vision: torch.Tensor | None = None,
             sync_ctx=None) -> torch.Tensor:
        """Mean next-token cross-entropy of a (B, S) batch (the chunked
        ``lm_head_loss``), plus the MoE layers' aux losses summed in layer
        order over ``num_layers``."""
        x, aux = self.forward(ids, vision, sync_ctx)
        with timing.span("loss"):
            ce = lm_head_loss(self._lm_weights(sync_ctx), x, labels,
                              ctx=self.ctx, vocab=self.cfg.vocab_size)
        return ce + aux / max(self.cfg.num_layers, 1)

    @torch.inference_mode()
    def prefill(self, ids: torch.Tensor, vision: torch.Tensor | None = None,
                *, max_len: int, cache_shards: int = 1
                ) -> tuple[torch.Tensor, list]:
        """Serving's prefill of a (B, S) prompt: (the last position's
        float32 logits (B, V), the caches for decode steps up to position
        ``max_len`` - 1), the caches laid out as ``init_cache``'s: this
        rank's shards, attention's of ``cache_shards`` (the reference's
        default of 1 keeps the whole ring on shard 0)."""
        cd, G = self.compute_dtype, self.cfg.group_size
        x = embed_lookup(self.ctx, self._embed_weights(None), ids)
        per_layer = []
        for i, layer in enumerate(self.layers):
            x, _, c = layer(x, vision, PREFILL, max_len=max_len,
                            weights=self._slot_weights(i, None),
                            cache_shards=cache_shards,
                            seq_ctxs=self.seq_ctxs)
            per_layer.append(c)
        x = rms_norm(x[:, -1], self.final_norm.to(cd), self.cfg.norm_eps)
        caches = [tuple(torch.stack([c[i] for c in per_layer[s::G]])
                        for i in range(2)) for s in range(G)]
        return self._logits(x), caches

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return lm_head_logits(self._lm_weights(None), x, self.ctx,
                              self.cfg.vocab_size)

    @torch.inference_mode()
    def decode(self, token: torch.Tensor, pos: torch.Tensor, caches: list,
               vision: torch.Tensor | None = None,
               cache_shards: int | None = None
               ) -> tuple[torch.Tensor, list]:
        """One decode step: ``token`` (B,) ids at absolute positions
        ``pos`` (B,) against ``caches`` (``prefill``'s or ``init_cache``'s
        layout), which are updated in place.  ``cache_shards`` defaults to
        the product of the ``seq_shard_axes`` groups' sizes, as the
        reference's.  Returns (float32 logits (B, V), the caches)."""
        cd, G = self.compute_dtype, self.cfg.group_size
        if cache_shards is None:
            cache_shards = shard_of(self.seq_ctxs)[0]
        x = embed_lookup(self.ctx, self._embed_weights(None), token[:, None])
        for i, layer in enumerate(self.layers):
            g, s = divmod(i, G)
            views = tuple(t[g] for t in caches[s])
            x, _, new = layer(x, vision, DECODE, views, pos,
                              weights=self._slot_weights(i, None),
                              cache_shards=cache_shards,
                              seq_ctxs=self.seq_ctxs)
            for view, t in zip(views, new):
                if t is not view:
                    view.copy_(t)
        x = rms_norm(x[:, 0], self.final_norm.to(cd), self.cfg.norm_eps)
        return self._logits(x), caches

    def _cache_shapes(self, batch: int, max_len: int, cache_shards: int,
                      dtype: torch.dtype | None, local: bool) -> list:
        """((shape, dtype), (shape, dtype)) of each slot's cache leaves,
        one rank's (``local``) or the global ones."""
        cfg = self.cfg
        dtype = dtype or self.compute_dtype
        tp = self.tp if local else 1
        lead = (cfg.num_groups, batch)
        out = []
        for slot in range(cfg.group_size):
            kind = cfg.slot_kind(slot)
            if kind == RWKV:
                H, hd = rwkv_dims(cfg, tp)
                shapes = (((H, hd, hd), torch.float32),
                          ((1, cfg.d_model), dtype))
            elif kind == MAMBA:
                di = mamba_dims(cfg, tp)
                shapes = (((di, cfg.mamba_d_state), torch.float32),
                          ((cfg.mamba_conv - 1, di), dtype))
            else:
                C, C_local = cache_spec(cfg, cfg.slot_attn_kind(slot),
                                        max_len, cache_shards)
                kv = (C_local if local else C, cfg.num_kv_heads,
                      cfg.head_dim_)
                shapes = (kv, dtype), (kv, dtype)
            out.append(tuple((lead + shape, dt) for shape, dt in shapes))
        return out

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype | None = None, *,
                   cache_shards: int = 1) -> list:
        """Zero caches of ``batch`` rows in this rank's shapes, one entry
        per layer slot, each stacked (num_groups, batch, ...): attention
        (k, v) of (C_local, KV, hd) in ``dtype`` (``cache_spec`` with
        ``cache_shards``); RWKV (state (H, hd, hd) float32 of this rank's
        heads, prev_x (1, d) in ``dtype``); Mamba (h (d_inner, d_state)
        float32, conv (width - 1, d_inner) in ``dtype``, this rank's
        channels).  ``dtype`` defaults to the compute dtype, that of
        ``prefill``'s caches."""
        dev = self.flat.device
        return [tuple(torch.zeros(shape, dtype=dt, device=dev)
                      for shape, dt in leaves)
                for leaves in self._cache_shapes(batch, max_len,
                                                 cache_shards, dtype, True)]

    def global_cache_shapes(self, batch_global: int, max_len: int,
                            cache_shards: int,
                            dtype: torch.dtype | None = None) -> list:
        """((shape, dtype), (shape, dtype)) of each slot's cache leaves in
        the global layout (the reference's ``global_cache_struct``): every
        rank's shards of ``cache_layout`` put together."""
        return self._cache_shapes(batch_global, max_len, cache_shards, dtype,
                                  False)

    def cache_layout(self, batch_axes: tuple[str, ...] = ()) -> list:
        """Which dims of each cache leaf are split over which groups (the
        reference's ``cache_pspecs``): ``cache_layout(cfg, batch_axes,
        seq_shard_axes)``."""
        return cache_layout(self.cfg, batch_axes, self.seq_shard_axes)

    def _part(self, axes: tuple[str, ...]) -> tuple[int, int]:
        return shard_of([self.groups[ax] for ax in axes])

    def shard_caches(self, caches: list, batch_axes: tuple[str, ...] = ()
                     ) -> list:
        """Global caches -> this rank's (copies), cut as ``cache_layout
        (batch_axes)`` says."""
        return [tuple(narrow_to(t, spec, self._part).clone()
                      for t, spec in zip(leaves, specs))
                for leaves, specs in zip(caches,
                                         self.cache_layout(batch_axes))]

    def gather_caches(self, caches: list, batch_axes: tuple[str, ...] = ()
                      ) -> list:
        """This rank's caches -> the global ones, on every rank (a
        collective: every rank of the groups calls it).  A dim split over
        several groups is gathered over the last (innermost) first."""
        out = []
        for leaves, specs in zip(caches, self.cache_layout(batch_axes)):
            whole = []
            for t, spec in zip(leaves, specs):
                for dim, axes in enumerate(spec):
                    for ax in reversed(axes or ()):
                        t = torch.cat(list(tp_all_gather(self.groups[ax], t)),
                                      dim=dim)
                whole.append(t)
            out.append(tuple(whole))
        return out


def cache_layout(cfg: ModelConfig, batch_axes: tuple[str, ...] = (),
                 seq_shard_axes: tuple[str, ...] = ("model",)) -> list:
    """For each layer slot, for each of its two cache leaves, a spec of
    its leading dims (as a ``PartitionSpec``): None, or the groups ("data",
    "model") that split the dim, the first outermost.  Attention's k and
    v: (None, batch, seq_shard_axes); RWKV6's state (None, batch,
    ("model",)) and prev_x (None, batch); Mamba's h (None, batch,
    ("model",)) and conv (None, batch, None, ("model",))."""
    b = tuple(batch_axes) or None
    seq = tuple(seq_shard_axes)
    out = []
    for slot in range(cfg.group_size):
        kind = cfg.slot_kind(slot)
        if kind == RWKV:
            out.append(((None, b, ("model",)), (None, b)))
        elif kind == MAMBA:
            out.append(((None, b, ("model",)), (None, b, None, ("model",))))
        else:
            out.append(((None, b, seq), (None, b, seq)))
    return out


def narrow_to(t: torch.Tensor, spec: tuple, part) -> torch.Tensor:
    """The block of ``t`` (a global leaf) that ``spec`` (``cache_layout``'s)
    gives one rank: ``part(axes)`` -> (blocks, this rank's block) of a dim
    split over ``axes``.  A view."""
    for dim, axes in enumerate(spec):
        if axes:
            n, i = part(tuple(axes))
            size = t.shape[dim] // n
            t = t.narrow(dim, i * size, size)
    return t

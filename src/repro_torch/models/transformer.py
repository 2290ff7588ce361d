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

Serving runs the same layers in another mode (``PREFILL``: the sequence
forward that also returns each mixer's decode cache; ``DECODE``: one
token a row against those caches), without autograd.  Caches keep the
reference's layout: a list with one entry per layer slot, each a tuple
of tensors stacked over the groups as (num_groups, B, ...).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .attention import (attn_decode, attn_forward, cache_spec,
                        cross_attn_forward)
from .config import MAMBA, RWKV, ModelConfig
from .layers import lm_head_logits, lm_head_loss, rms_norm, swiglu
from .mamba import A_LOG_INIT, mamba_dims, mamba_forward, mamba_specs
from .moe import moe_ffn
from .rwkv import rwkv_decode, rwkv_dims, rwkv_forward, rwkv_specs

# init codes: -1 ones (norm weights), 0 zeros (biases and the cross gate),
# A_LOG_INIT (-2) Mamba's log(1..d_state), > 0 normal * in_dim ** -0.5
_ONES = -1
_ZEROS = 0

# what a layer runs: the training forward, serving's prefill (the same
# forward, also returning the caches) or one decode step
TRAIN, PREFILL, DECODE = "train", "prefill", "decode"

def _slot_specs(cfg: ModelConfig, slot: int
                ) -> dict[str, tuple[tuple, int]]:
    """leaf path within layer slot ``slot`` -> (per-layer shape, init
    code), the reference's ``slot_param_specs``: the norms, the mixer
    (attention, the RWKV6 time-mix or Mamba), the cross-attention block
    on a VLM's cross slots, and the FFN (SwiGLU or MoE)."""
    d, ff, hd = cfg.d_model, cfg.d_ff, cfg.head_dim_
    nq, nkv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    specs = {"norm1": ((d,), _ONES), "norm2": ((d,), _ONES)}
    kind = cfg.slot_kind(slot)
    if kind == RWKV:
        specs.update({f"mixer.{k}": v for k, v in rwkv_specs(cfg).items()})
    elif kind == MAMBA:
        specs.update({f"mixer.{k}": v for k, v in mamba_specs(cfg).items()})
    else:
        specs.update({"mixer.wk": ((d, nkv), d),
                      "mixer.wo": ((nq, d), nq),
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
                      "cross.wo": ((nq, d), nq),
                      "cross.wq": ((d, nq), d),
                      "cross.wv": ((d, nkv), d)})
    if cfg.slot_is_moe(slot):
        E = cfg.num_experts
        specs.update({"ffn.router": ((d, E), d),
                      "ffn.w1": ((E, d, ff), d),
                      "ffn.w2": ((E, ff, d), ff),
                      "ffn.w3": ((E, d, ff), d)})
        if cfg.shared_expert:
            specs.update({"ffn.sw1": ((d, ff), d),
                          "ffn.sw2": ((ff, d), ff),
                          "ffn.sw3": ((d, ff), d)})
    else:
        specs.update({"ffn.w1": ((d, ff), d),
                      "ffn.w2": ((ff, d), ff),
                      "ffn.w3": ((d, ff), d)})
    return specs


def slot_layout(cfg: ModelConfig, slot: int
                ) -> list[tuple[str, tuple, int]]:
    """(leaf path, per-layer shape, init code) of layer slot ``slot``, in
    the order of sorted nested keys (a block's leaves together)."""
    specs = _slot_specs(cfg, slot)
    return [(path, *specs[path])
            for path in sorted(specs, key=lambda p: p.split("."))]


def param_layout(cfg: ModelConfig) -> list[tuple[str, tuple, int]]:
    """(name, shape, init code) of every leaf, in flat (ravel) order:
    ``embed``, ``final_norm``, ``lm_head``, then ``slots``, a list of
    ``group_size`` dicts whose leaves are stacked as (num_groups, 1,
    ...), each with its keys sorted."""
    d, V, G = cfg.d_model, cfg.vocab_size, cfg.num_groups
    layout = [("embed", (1, V, d), d), ("final_norm", (d,), _ONES),
              ("lm_head", (1, d, V), d)]
    for slot in range(cfg.group_size):
        layout += [(f"slots.{slot}.{path}", (G, 1, *shape), code)
                   for path, shape, code in slot_layout(cfg, slot)]
    return layout


def init_flat(layout, dtype: torch.dtype, device, seed: int
              ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """A flat buffer for ``layout`` ((name, shape, init code) triples)
    and a view of it per name, drawn by init code with a
    ``torch.Generator`` on ``device`` seeded ``seed``."""
    flat = torch.empty(sum(math.prod(shape) for _, shape, _ in layout),
                       dtype=dtype, device=device)
    gen = torch.Generator(device=flat.device).manual_seed(seed)
    views, off = {}, 0
    for name, shape, code in layout:
        n = math.prod(shape)
        view = flat[off:off + n].view(shape)
        if code == _ONES:
            view.fill_(1.0)
        elif code == A_LOG_INIT:
            view.copy_(torch.log(torch.arange(
                1, shape[-1] + 1, dtype=torch.float32, device=flat.device)))
        elif code == _ZEROS:
            view.zero_()
        else:
            view.normal_(generator=gen).mul_(code ** -0.5)
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

    def __init__(self, cfg: ModelConfig, leaves: dict[str, torch.Tensor],
                 slot: int):
        super().__init__()
        self.cfg = cfg
        self.kind = cfg.slot_kind(slot)
        self.attn_kind = cfg.slot_attn_kind(slot)
        self.is_moe = cfg.slot_is_moe(slot)
        self.has_cross = cfg.slot_has_cross(slot)
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

    def forward(self, x: torch.Tensor, vision: torch.Tensor | None = None,
                mode: str = TRAIN, cache: tuple | None = None,
                pos: torch.Tensor | None = None, max_len: int = 0
                ) -> tuple[torch.Tensor, torch.Tensor, tuple | None]:
        """x: (B, S, d) -> (x, the MoE aux loss or 0, the mixer's cache or
        None).  ``mode``: ``TRAIN``; ``PREFILL``, which also returns the
        decode cache (attention's of ``max_len`` slots at most); or
        ``DECODE``, one token a row (S = 1) at positions ``pos`` (B,)
        against ``cache``.  A cross slot runs its cross-attention block
        only when ``vision`` is given."""
        cfg, cd = self.cfg, x.dtype
        mixer = {k: v.to(cd) for k, v in self.mixer.items()}
        h = rms_norm(x, self.norm1.to(cd), cfg.norm_eps)
        prefill = mode == PREFILL
        if self.kind == RWKV:
            out = (rwkv_decode(cfg, mixer, h, cache) if mode == DECODE else
                   rwkv_forward(cfg, mixer, h, return_state=prefill))
        elif self.kind == MAMBA:        # decode: the forward on one token
            out = mamba_forward(cfg, mixer, h, cache=cache,
                                return_state=mode != TRAIN)
        elif mode == DECODE:
            out = attn_decode(cfg, mixer, h, pos, cache, self.attn_kind)
        else:
            out = attn_forward(cfg, mixer, h, self.attn_kind,
                               return_cache=prefill, max_len=max_len)
        mix, cache = (out, None) if mode == TRAIN else out
        x = x + mix.to(cd)
        if self.has_cross and vision is not None:
            cross = {k: v.to(cd) for k, v in self.cross.items()}
            h = rms_norm(x, self.cross_norm.to(cd), cfg.norm_eps)
            x = x + cross_attn_forward(cfg, cross, h, vision).to(cd)
        ffn = {k: v.to(cd) for k, v in self.ffn.items()}
        h = rms_norm(x, self.norm2.to(cd), cfg.norm_eps)
        if self.is_moe:
            y, aux = moe_ffn(cfg, ffn, h)
        else:
            y, aux = swiglu(h, ffn["w1"], ffn["w3"], ffn["w2"]), 0.0
        return x + y, aux, cache


class Model(nn.Module):
    """Decoder whose parameters live in one flat buffer of the config's
    ``param_dtype``.

    ``seed`` draws the weights with a ``torch.Generator`` on ``device``
    (normal * in_dim ** -0.5, norm weights 1, Mamba's A_log
    log(1..d_state)); ``load_flat`` replaces them, e.g. with weights
    carried over from the reference (``repro_torch.weights``).
    """

    def __init__(self, cfg: ModelConfig, *, device="cuda", seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        self.flat, lv = init_flat(param_layout(cfg),
                                  getattr(torch, cfg.param_dtype), device,
                                  seed)
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
                layers.append(DecoderLayer(cfg, leaves, slot))
        self.layers = nn.ModuleList(layers)

    def load_flat(self, flat: torch.Tensor) -> None:
        """Copy a flat (ravel-ordered) parameter vector into the buffer."""
        if flat.shape != self.flat.shape:
            raise ValueError(f"flat params {tuple(flat.shape)} != "
                             f"({self.d},)")
        self.flat.copy_(flat)

    def attach_grads(self, grad_flat: torch.Tensor) -> None:
        """Point every parameter's ``.grad`` at its slice of
        ``grad_flat`` (d,), which the next backward accumulates into."""
        attach_grads(self, self.flat, grad_flat)

    def forward(self, ids: torch.Tensor, vision: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """The training forward of a (B, S) batch: (the hidden states after
        the final norm (B, S, d), the MoE layers' aux losses summed).
        ``vision``: (B, S_img, d_model) image embeddings for the VLM's
        cross slots (without them those blocks are skipped)."""
        cd = self.compute_dtype
        x = F.embedding(ids, self.embed.to(cd))
        aux = 0.0
        for layer in self.layers:
            x, a, _ = layer(x, vision)
            aux = aux + a
        return rms_norm(x, self.final_norm.to(cd), self.cfg.norm_eps), aux

    def loss(self, ids: torch.Tensor, labels: torch.Tensor,
             vision: torch.Tensor | None = None) -> torch.Tensor:
        """Mean next-token cross-entropy of a (B, S) batch, plus the MoE
        layers' aux losses summed in layer order over ``num_layers``."""
        x, aux = self.forward(ids, vision)
        ce = lm_head_loss(self.lm_head.to(self.compute_dtype), x, labels)
        return ce + aux / max(self.cfg.num_layers, 1)

    @torch.inference_mode()
    def prefill(self, ids: torch.Tensor, vision: torch.Tensor | None = None,
                *, max_len: int) -> tuple[torch.Tensor, list]:
        """Serving's prefill of a (B, S) prompt: (the last position's
        float32 logits (B, V), the caches for decode steps up to position
        ``max_len`` - 1), the caches laid out as ``init_cache``'s."""
        cd, G = self.compute_dtype, self.cfg.group_size
        x = F.embedding(ids, self.embed.to(cd))
        per_layer = []
        for layer in self.layers:
            x, _, c = layer(x, vision, PREFILL, max_len=max_len)
            per_layer.append(c)
        x = rms_norm(x[:, -1], self.final_norm.to(cd), self.cfg.norm_eps)
        caches = [tuple(torch.stack([c[i] for c in per_layer[s::G]])
                        for i in range(2)) for s in range(G)]
        return lm_head_logits(self.lm_head.to(cd), x), caches

    @torch.inference_mode()
    def decode(self, token: torch.Tensor, pos: torch.Tensor, caches: list,
               vision: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, list]:
        """One decode step: ``token`` (B,) ids at absolute positions
        ``pos`` (B,) against ``caches`` (``prefill``'s or ``init_cache``'s
        layout), which are updated in place.  Returns (float32 logits
        (B, V), the caches)."""
        cd, G = self.compute_dtype, self.cfg.group_size
        x = F.embedding(token[:, None], self.embed.to(cd))
        for i, layer in enumerate(self.layers):
            g, s = divmod(i, G)
            views = tuple(t[g] for t in caches[s])
            x, _, new = layer(x, vision, DECODE, views, pos)
            for view, t in zip(views, new):
                if t is not view:
                    view.copy_(t)
        x = rms_norm(x[:, 0], self.final_norm.to(cd), self.cfg.norm_eps)
        return lm_head_logits(self.lm_head.to(cd), x), caches

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype | None = None) -> list:
        """Zero caches of ``batch`` rows, one entry per layer slot, each
        stacked (num_groups, batch, ...): attention (k, v) of (C, KV, hd)
        in ``dtype`` (C from ``cache_spec``); RWKV (state (H, hd, hd)
        float32, prev_x (1, d) in ``dtype``); Mamba (h (d_inner, d_state)
        float32, conv (width - 1, d_inner) in ``dtype``).  ``dtype``
        defaults to the compute dtype, that of ``prefill``'s caches."""
        cfg = self.cfg
        dtype = dtype or self.compute_dtype
        lead = (cfg.num_groups, batch)
        dev = self.flat.device
        out = []
        for slot in range(cfg.group_size):
            kind = cfg.slot_kind(slot)
            if kind == RWKV:
                H, hd = rwkv_dims(cfg)
                shapes = (((H, hd, hd), torch.float32),
                          ((1, cfg.d_model), dtype))
            elif kind == MAMBA:
                di = mamba_dims(cfg)
                shapes = (((di, cfg.mamba_d_state), torch.float32),
                          ((cfg.mamba_conv - 1, di), dtype))
            else:
                C = cache_spec(cfg, cfg.slot_attn_kind(slot), max_len)
                kv = (C, cfg.num_kv_heads, cfg.head_dim_)
                shapes = (kv, dtype), (kv, dtype)
            out.append(tuple(torch.zeros(lead + shape, dtype=dt, device=dev)
                             for shape, dt in shapes))
        return out

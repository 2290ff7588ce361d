"""The decoder stack, with its parameters in one flat buffer.

Every parameter is a view into ``Model.flat``, a float32 vector laid out
exactly as the reference's ``ravel_pytree(params)`` flattens its
parameter tree: dict keys sorted, ``slots`` a list of ``group_size``
layer slots, and each slot's leaves stacked over the groups as
``(num_groups, tp=1, ...)``, so all groups' ``w1`` of a slot come before
their ``w2``.  Bucket membership, and with it every norm and code on the
wire, depends on this order.

Because the parameters alias the buffer, the flat vector needs no copy:
``attach_grads(g)`` points every parameter's ``.grad`` at its slice of a
flat gradient row ``g``, and a backward pass then accumulates the
worker's gradient straight into ``g`` (autograd adds into a defined
``.grad`` in place).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .attention import attn_forward
from .config import RWKV, ModelConfig
from .layers import lm_head_loss, rms_norm, swiglu
from .moe import moe_ffn
from .rwkv import rwkv_forward, rwkv_specs

# init codes: -1 ones (norm weights), 0 zeros (biases), > 0 normal *
# in_dim ** -0.5
_ONES = -1
_ZEROS = 0

def _slot_specs(cfg: ModelConfig, slot: int
                ) -> dict[str, tuple[tuple, int]]:
    """leaf path within layer slot ``slot`` -> (per-layer shape, init
    code), the reference's ``slot_param_specs``: the norms, the mixer
    (attention or RWKV6 time-mix) and the FFN (SwiGLU or MoE)."""
    d, ff, hd = cfg.d_model, cfg.d_ff, cfg.head_dim_
    specs = {"norm1": ((d,), _ONES), "norm2": ((d,), _ONES)}
    if cfg.slot_kind(slot) == RWKV:
        specs.update({f"mixer.{k}": v for k, v in rwkv_specs(cfg).items()})
    else:
        nq, nkv = cfg.num_heads * hd, cfg.num_kv_heads * hd
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


def param_layout(cfg: ModelConfig) -> list[tuple[str, tuple, int]]:
    """(name, shape, init code) of every leaf, in flat (ravel) order:
    ``embed``, ``final_norm``, ``lm_head``, then ``slots``, a list of
    ``group_size`` dicts whose leaves are stacked as (num_groups, 1,
    ...), each with its keys sorted."""
    d, V, G = cfg.d_model, cfg.vocab_size, cfg.num_groups
    layout = [("embed", (1, V, d), d), ("final_norm", (d,), _ONES),
              ("lm_head", (1, d, V), d)]
    for slot in range(cfg.group_size):
        specs = _slot_specs(cfg, slot)
        for path in sorted(specs):   # the order of sorted nested keys
            shape, code = specs[path]
            layout.append((f"slots.{slot}.{path}", (G, 1, *shape), code))
    return layout


class DecoderLayer(nn.Module):
    """Pre-norm block of one layer slot: a mixer (attention of the slot's
    ``attn_kind``, or the RWKV6 time-mix) and an FFN (SwiGLU, or MoE).
    ``leaves`` maps the slot's leaf paths (``norm1``, ``mixer.wq``,
    ``ffn.w1``, ...) to views into the flat buffer."""

    def __init__(self, cfg: ModelConfig, leaves: dict[str, torch.Tensor],
                 slot: int):
        super().__init__()
        self.cfg = cfg
        self.kind = cfg.slot_kind(slot)
        self.attn_kind = cfg.slot_attn_kind(slot)
        self.is_moe = cfg.slot_is_moe(slot)
        self.norm1 = nn.Parameter(leaves["norm1"])
        self.norm2 = nn.Parameter(leaves["norm2"])
        self.mixer = nn.ParameterDict()
        self.ffn = nn.ParameterDict()
        for path, view in leaves.items():
            group, _, name = path.partition(".")
            if name:
                getattr(self, group)[name] = nn.Parameter(view)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x: (B, S, d) -> (x, the MoE aux loss or 0)."""
        cfg, cd = self.cfg, x.dtype
        mixer = {k: v.to(cd) for k, v in self.mixer.items()}
        h = rms_norm(x, self.norm1.to(cd), cfg.norm_eps)
        if self.kind == RWKV:
            mix = rwkv_forward(cfg, mixer, h)
        else:
            mix = attn_forward(cfg, mixer, h, self.attn_kind)
        x = x + mix.to(cd)
        ffn = {k: v.to(cd) for k, v in self.ffn.items()}
        h = rms_norm(x, self.norm2.to(cd), cfg.norm_eps)
        if self.is_moe:
            y, aux = moe_ffn(cfg, ffn, h)
        else:
            y, aux = swiglu(h, ffn["w1"], ffn["w3"], ffn["w2"]), 0.0
        return x + y, aux


class Model(nn.Module):
    """Decoder whose parameters live in one flat float32 buffer.

    ``seed`` draws the weights with a ``torch.Generator`` on ``device``
    (normal * in_dim ** -0.5, norm weights 1); ``load_flat`` replaces
    them, e.g. with weights carried over from the reference
    (``repro_torch.weights``).
    """

    def __init__(self, cfg: ModelConfig, *, device="cuda", seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        layout = param_layout(cfg)
        self.d = sum(math.prod(shape) for _, shape, _ in layout)
        self.flat = torch.empty(self.d, dtype=torch.float32, device=device)
        lv: dict[str, torch.Tensor] = {}
        gen = torch.Generator(device=self.flat.device).manual_seed(seed)
        off = 0
        for name, shape, code in layout:
            n = math.prod(shape)
            view = self.flat[off:off + n].view(shape)
            if code == _ONES:
                view.fill_(1.0)
            elif code == _ZEROS:
                view.zero_()
            else:
                view.normal_(generator=gen).mul_(code ** -0.5)
            lv[name] = view
            off += n
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
        base = self.flat.data_ptr()
        for p in self.parameters():
            off = (p.data_ptr() - base) // 4
            p.grad = grad_flat[off:off + p.numel()].view(p.shape)

    def loss(self, ids: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Mean next-token cross-entropy of a (B, S) batch, plus the MoE
        layers' aux losses summed in layer order over ``num_layers``."""
        cd = self.compute_dtype
        x = F.embedding(ids, self.embed.to(cd))
        aux = 0.0
        for layer in self.layers:
            x, a = layer(x)
            aux = aux + a
        x = rms_norm(x, self.final_norm.to(cd), self.cfg.norm_eps)
        ce = lm_head_loss(self.lm_head.to(cd), x, labels)
        return ce + aux / max(self.cfg.num_layers, 1)

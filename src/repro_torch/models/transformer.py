"""The dense decoder stack, with its parameters in one flat buffer.

Every parameter is a view into ``Model.flat``, a float32 vector laid out
exactly as the reference's ``ravel_pytree(params)`` flattens its
parameter tree: dict keys sorted, and each per-layer leaf stacked over
the layers as ``(num_layers, tp=1, ...)``, so all layers' ``w1`` come
before all layers' ``w2``.  Bucket membership, and with it every norm
and code on the wire, depends on this order.

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

from .attention import causal_attention
from .config import ModelConfig
from .layers import lm_head_loss, rms_norm, swiglu

# init codes: -1 ones (norm weights), > 0 normal * in_dim ** -0.5
_ONES = -1


def param_layout(cfg: ModelConfig) -> list[tuple[str, tuple, int]]:
    """(name, shape, init code) of every leaf, in flat (ravel) order."""
    d, ff, V, G = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.num_layers
    hd = cfg.head_dim_
    nq, nkv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    return [
        ("embed", (1, V, d), d),
        ("final_norm", (d,), _ONES),
        ("lm_head", (1, d, V), d),
        ("slots.0.ffn.w1", (G, 1, d, ff), d),
        ("slots.0.ffn.w2", (G, 1, ff, d), ff),
        ("slots.0.ffn.w3", (G, 1, d, ff), d),
        ("slots.0.mixer.wk", (G, 1, d, nkv), d),
        ("slots.0.mixer.wo", (G, 1, nq, d), nq),
        ("slots.0.mixer.wq", (G, 1, d, nq), d),
        ("slots.0.mixer.wv", (G, 1, d, nkv), d),
        ("slots.0.norm1", (G, 1, d), _ONES),
        ("slots.0.norm2", (G, 1, d), _ONES),
    ]


class DecoderLayer(nn.Module):
    """Pre-norm attention + SwiGLU block; ``leaves`` maps the short leaf
    names (``w1``, ``wq``, ``norm1``, ...) to views into the flat buffer."""

    def __init__(self, cfg: ModelConfig, leaves: dict[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        for name, view in leaves.items():
            self.register_parameter(name, nn.Parameter(view))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg, cd = self.cfg, x.dtype
        h = rms_norm(x, self.norm1.to(cd), cfg.norm_eps)
        x = x + causal_attention(
            h, self.wq.to(cd), self.wk.to(cd), self.wv.to(cd),
            self.wo.to(cd), num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim_,
            theta=cfg.rope_theta)
        h = rms_norm(x, self.norm2.to(cd), cfg.norm_eps)
        return x + swiglu(h, self.w1.to(cd), self.w3.to(cd), self.w2.to(cd))


class Model(nn.Module):
    """Dense decoder whose parameters live in one flat float32 buffer.

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
            else:
                view.normal_(generator=gen).mul_(code ** -0.5)
            lv[name] = view
            off += n
        self.embed = nn.Parameter(lv["embed"][0])
        self.lm_head = nn.Parameter(lv["lm_head"][0])
        self.final_norm = nn.Parameter(lv["final_norm"])
        short = {name.rsplit(".", 1)[1]: name for name in lv
                 if name.startswith("slots.")}
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, {k: lv[full][g, 0] for k, full in short.items()})
            for g in range(cfg.num_layers))

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
        """Mean next-token cross-entropy of a (B, S) batch."""
        cd = self.compute_dtype
        x = F.embedding(ids, self.embed.to(cd))
        for layer in self.layers:
            x = layer(x)
        x = rms_norm(x, self.final_norm.to(cd), self.cfg.norm_eps)
        return lm_head_loss(self.lm_head.to(cd), x, labels)

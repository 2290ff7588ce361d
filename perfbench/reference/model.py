"""The plain reference of the benchmark's models: the forward pass and
the mean next-token cross-entropy of a decoder of pre-norm layer slots,
each a mixer and an FFN whose equations are their layer kinds'
(``layers/``), in plain PyTorch.

It computes as the configuration states: parameters float32, cast to
the compute dtype (bfloat16) for every matmul; norms, softmax, the
recurrences and the loss in float32.  The equations are those of the
reference package's layers (the port's ``models/`` follows the same
ones); the departures are in the order of float32 work only (the
attention is one plain softmax over the masked scores, where the port
runs a blockwise loop).  Each layer runs under a checkpoint and the
head's loss in chunks of 512 positions, so that one worker's gradient
fits beside the reference's state.

``fp8=True`` rounds both inputs of every matmul to float8 (e4m3, one
scale a tensor) in the forward: the next precision below the stated
bfloat16, which the benchmark's control computes in.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from harness import shapes

LOSS_CHUNK = 512
F8_MAX = 448.0


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale (its largest magnitude at
    the format's largest), in x's dtype; the gradient passes straight
    through the rounding."""
    scale = (x.detach().abs().amax().float() / F8_MAX).clamp(min=1e-30)
    q = (x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q.to(x.dtype) - x).detach()


def _role(p: dict, role: str) -> dict:
    """The leaves of ``p`` under ``role.``, by their paths within it."""
    return {k[len(role) + 1:]: t for k, t in p.items()
            if k.startswith(role + ".")}


class Reference:
    """The model of the configuration numbers ``m`` over a dict of leaves
    (float32, each shaped as ``harness.shapes.leaves`` lays it out)."""

    def __init__(self, m: dict, fp8: bool = False):
        self.m = m
        self.cd = getattr(torch, m.get("compute_dtype", "bfloat16"))
        self.eps = m.get("norm_eps", 1e-5)
        self.fp8 = fp8
        self.slots = shapes.slots(m)

    # ---- the helpers of the layer kinds' equations ------------------------

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            a, b = _round_fp8(a), _round_fp8(b)
        return a @ b

    def rms(self, x, w):
        x32 = x.float()
        y = x32 * torch.rsqrt(torch.mean(x32 * x32, -1, keepdim=True)
                              + self.eps)
        return y.to(x.dtype) * w

    def rope(self, x):
        S, half = x.shape[1], x.shape[-1] // 2
        freqs = self.m.get("rope_theta", 1e6) ** (
            -torch.arange(0, half, dtype=torch.float32, device=x.device)
            / half)
        ang = torch.arange(S, device=x.device).float()[:, None, None] * freqs
        cos, sin = torch.cos(ang), torch.sin(ang)
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                         -1).to(x.dtype)

    # ---- the stack and the loss -----------------------------------------

    def layer(self, leaves, i, x):
        """Layer i: slot i % group_size of group i // group_size."""
        j = i % len(self.slots)
        pre = f"slots.{j}."
        p = {name[len(pre):]: t[i // len(self.slots), 0].to(self.cd)
             for name, t in leaves.items() if name.startswith(pre)}
        mixer, ffn = self.slots[j]
        h = self.rms(x, p["norm1"])
        x = x + mixer.forward(self, _role(p, "mixer"), h, j).to(self.cd)
        h = self.rms(x, p["norm2"])
        return x + ffn.forward(self, _role(p, "ffn"), h, j).to(self.cd)

    def _ce(self, w, x, labels):
        logits = self.mm(x, w).float()
        mx = torch.amax(logits, -1).detach()
        lse = mx + torch.log(torch.sum(torch.exp(logits - mx[..., None]), -1))
        picked = torch.gather(logits, -1, labels[..., None])[..., 0]
        return torch.sum(lse - picked)

    def loss(self, leaves: dict, ids: torch.Tensor, labels: torch.Tensor
             ) -> torch.Tensor:
        """Mean next-token cross-entropy of the (B, S) rows."""
        B, S = ids.shape
        x = F.embedding(ids, leaves["embed"][0].to(self.cd))
        for i in range(self.m["num_layers"]):
            x = checkpoint(self.layer, leaves, i, x, use_reentrant=False)
        x = self.rms(x, leaves["final_norm"].to(self.cd))
        w = leaves["lm_head"][0].to(self.cd)
        if S <= LOSS_CHUNK or S % LOSS_CHUNK:
            return self._ce(w, x, labels) / (B * S)
        total = torch.zeros((), device=x.device)
        for c in range(0, S, LOSS_CHUNK):
            total = total + checkpoint(
                self._ce, w, x[:, c:c + LOSS_CHUNK],
                labels[:, c:c + LOSS_CHUNK], use_reentrant=False)
        return total / (B * S)

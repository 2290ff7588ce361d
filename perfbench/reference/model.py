"""The plain reference of the benchmark's models: the forward pass and
the mean next-token cross-entropy of a decoder whose layers are either
attention (GQA with RoPE, optional qk-norm, causal) or RWKV6's time-mix,
each followed by a SwiGLU FFN, in plain PyTorch.

It computes as the configuration states: parameters float32, cast to
the compute dtype (bfloat16) for every matmul; norms, softmax, the
RWKV6 recurrence, its output projection and the loss in float32.  The
equations are those of the reference package's layers (the port's
``models/`` follows the same ones); the departures are in the order of
float32 work only: the attention is one plain softmax over the causal
scores, where the port runs a blockwise loop.  Each layer runs under a
checkpoint and the head's loss in chunks of 512 positions, so that one
worker's gradient fits beside the reference's state.

``fp8=True`` rounds both inputs of every matmul to float8 (e4m3, one
scale a tensor) in the forward: the next precision below the stated
bfloat16, which the benchmark's control computes in.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

LOSS_CHUNK = 512
RWKV_CHUNK = 32
F8_MAX = 448.0


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale (its largest magnitude at
    the format's largest), in x's dtype; the gradient passes straight
    through the rounding."""
    scale = (x.detach().abs().amax().float() / F8_MAX).clamp(min=1e-30)
    q = (x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q.to(x.dtype) - x).detach()


class Reference:
    """The model of the configuration numbers ``m`` over a dict of leaves
    (float32, each shaped as ``harness.shapes.leaves`` lays it out)."""

    def __init__(self, m: dict, fp8: bool = False):
        self.m = m
        self.cd = getattr(torch, m.get("compute_dtype", "bfloat16"))
        self.eps = m.get("norm_eps", 1e-5)
        self.fp8 = fp8

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            a, b = _round_fp8(a), _round_fp8(b)
        return a @ b

    def rms(self, x, w):
        x32 = x.float()
        y = x32 * torch.rsqrt(torch.mean(x32 * x32, -1, keepdim=True)
                              + self.eps)
        return y.to(x.dtype) * w

    # ---- attention -------------------------------------------------------

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

    def attention(self, p, x):
        m = self.m
        B, S, _ = x.shape
        hd = m.get("head_dim") or m["d_model"] // m["num_heads"]
        H, KV = m["num_heads"], m["num_kv_heads"]
        q = self.mm(x, p["mixer.wq"]).reshape(B, S, H, hd)
        k = self.mm(x, p["mixer.wk"]).reshape(B, S, KV, hd)
        v = self.mm(x, p["mixer.wv"]).reshape(B, S, KV, hd)
        if "mixer.q_norm" in p:
            q = self.rms(q, p["mixer.q_norm"])
            k = self.rms(k, p["mixer.k_norm"])
        q, k = self.rope(q), self.rope(k)
        # kv head j serves the H // KV consecutive q heads from j * H // KV
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
        qt = q.transpose(1, 2).float() * hd ** -0.5
        s = qt @ k.transpose(1, 2).float().transpose(-1, -2)
        causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
        a = torch.softmax(s.masked_fill(~causal, float("-inf")), -1)
        o = (a @ v.transpose(1, 2).float()).transpose(1, 2).to(x.dtype)
        return self.mm(o.reshape(B, S, H * hd), p["mixer.wo"])

    # ---- RWKV6 -----------------------------------------------------------

    def rwkv(self, p, x):
        m = self.m
        B, S, d = x.shape
        hd = m.get("rwkv_head_dim", 64)
        H = d // hd
        xs = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], 1)

        def mix(mu):
            return x + (xs - x) * mu

        r = self.mm(mix(p["mixer.mu_r"]), p["mixer.proj_r"]).reshape(
            B, S, H, hd).float()
        k = self.mm(mix(p["mixer.mu_k"]), p["mixer.proj_k"]).reshape(
            B, S, H, hd).float()
        v = self.mm(mix(p["mixer.mu_v"]), p["mixer.proj_v"]).reshape(
            B, S, H, hd).float()
        g = self.mm(mix(p["mixer.mu_g"]), p["mixer.proj_g"])
        lora = self.mm(torch.tanh(self.mm(mix(p["mixer.mu_w"]),
                                          p["mixer.w_lora_a"])),
                       p["mixer.w_lora_b"])
        logw = -torch.exp(torch.clamp((p["mixer.w0"] + lora).float(),
                                      -8.0, 8.0)).reshape(B, S, H, hd)
        u = p["mixer.u"].reshape(H, hd).float()
        L = min(RWKV_CHUNK, S)
        tri = torch.ones(L, L, dtype=torch.bool, device=x.device).tril(-1)
        state = torch.zeros(B, H, hd, hd, device=x.device)
        outs = []
        for c in range(0, S, L):
            rc, kc, vc, wc = (t[:, c:c + L] for t in (r, k, v, logw))
            cw = torch.cumsum(wc, 1)
            cw_prev = cw - wc
            cross = torch.einsum("blhd,bhde->blhe", rc * torch.exp(cw_prev),
                                 state)
            D = torch.where(tri[None, :, :, None, None],
                            torch.exp(cw_prev[:, :, None] - cw[:, None]), 0.0)
            P = torch.einsum("bthd,bihd,btihd->btih", rc, kc, D)
            intra = torch.einsum("btih,bihe->bthe", P, vc)
            bonus = torch.einsum("bthd,hd,bthd->bth", rc, u, kc)[..., None] * vc
            kd = kc * torch.exp(cw[:, -1:] - cw)
            state = (torch.exp(cw[:, -1])[..., None] * state
                     + torch.einsum("bihd,bihe->bhde", kd, vc))
            outs.append(cross + intra + bonus)
        o = torch.cat(outs, 1)                           # (B, S, H, hd) f32
        o = o * torch.rsqrt(torch.mean(o * o, -1, keepdim=True) + self.eps)
        o = o.reshape(B, S, H * hd) * p["mixer.ln_x"]
        o = o * F.silu(g.float())
        # the state's float32 meets the output projection in float32
        return self.mm(o, p["mixer.wo"].float())

    # ---- the stack and the loss -----------------------------------------

    def layer(self, leaves, i, x):
        p = {name[len("slots.0."):]: t[i, 0].to(self.cd)
             for name, t in leaves.items() if name.startswith("slots.0.")}
        h = self.rms(x, p["norm1"])
        if self.m.get("layer_pattern", "attn") == "rwkv":
            x = x + self.rwkv(p, h).to(self.cd)
        else:
            x = x + self.attention(p, h).to(self.cd)
        h = self.rms(x, p["norm2"])
        y = self.mm(F.silu(self.mm(h, p["ffn.w1"])) * self.mm(h, p["ffn.w3"]),
                    p["ffn.w2"])
        return x + y

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

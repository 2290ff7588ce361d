"""RWKV6's time-mix (Finch), the mixer of every slot of
``layer_pattern: "rwkv"``: static token-shift mixes, a data-dependent
decay through a LoRA of 64, and the chunked recurrence, in float32 from
the projections on.

Three of its leaves are drawn as a trained model holds them, away from
their init: the token-shift mixes uniform in [0, 1], the decay base w0
uniform in [-4, -0.5], the decay LoRA's B at a fifth of its scale.
With the init's zero mixes and w0 the log decays of random tokens reach
tens a token, the chunked ``exp`` overflows and the gradient holds NaN;
with these they stay within about -0.01 to -1 a token.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

ROLE = "mixer"
KEYS = ("layer_pattern", "rwkv_head_dim")
LORA = 64
CHUNK = 32


def takes(m: dict, slot: int) -> bool:
    return m.get("layer_pattern") == "rwkv"


def leaves(m: dict, slot: int) -> dict:
    d = m["d_model"]
    hd = m.get("rwkv_head_dim", 64)
    dl = (d // hd) * hd
    out = {f"mu_{k}": ((d,), "mix", 0) for k in "rkvgw"}
    out.update({
        "w0": ((d,), "decay_base", 0),
        "w_lora_a": ((d, LORA), "normal", d),
        "w_lora_b": ((LORA, d), "decay_lora_b", LORA),
        "proj_r": ((d, dl), "normal", d),
        "proj_k": ((d, dl), "normal", d),
        "proj_v": ((d, dl), "normal", d),
        "proj_g": ((d, dl), "normal", d),
        "u": ((dl,), "zeros", 0),
        "ln_x": ((dl,), "ones", 0),
        "wo": ((dl, d), "normal", d)})
    return out


def active(m: dict, slot: int) -> int:
    """6 d^2, as the dry run counts the time-mix."""
    return 6 * m["d_model"] ** 2


DRAWS = {
    "mix": lambda view, gen, fan_in: view.uniform_(0.0, 1.0, generator=gen),
    "decay_base": lambda view, gen, fan_in: view.uniform_(-4.0, -0.5,
                                                         generator=gen),
    "decay_lora_b": lambda view, gen, fan_in: view.mul_(
        0.2 * fan_in ** -0.5),
}


def forward(ref, p, x, slot: int):
    m = ref.m
    B, S, d = x.shape
    hd = m.get("rwkv_head_dim", 64)
    H = d // hd
    xs = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], 1)

    def mix(mu):
        return x + (xs - x) * mu

    r = ref.mm(mix(p["mu_r"]), p["proj_r"]).reshape(B, S, H, hd).float()
    k = ref.mm(mix(p["mu_k"]), p["proj_k"]).reshape(B, S, H, hd).float()
    v = ref.mm(mix(p["mu_v"]), p["proj_v"]).reshape(B, S, H, hd).float()
    g = ref.mm(mix(p["mu_g"]), p["proj_g"])
    lora = ref.mm(torch.tanh(ref.mm(mix(p["mu_w"]), p["w_lora_a"])),
                  p["w_lora_b"])
    logw = -torch.exp(torch.clamp((p["w0"] + lora).float(),
                                  -8.0, 8.0)).reshape(B, S, H, hd)
    u = p["u"].reshape(H, hd).float()
    L = min(CHUNK, S)
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
    o = o * torch.rsqrt(torch.mean(o * o, -1, keepdim=True) + ref.eps)
    o = o.reshape(B, S, H * hd) * p["ln_x"]
    o = o * F.silu(g.float())
    # the state's float32 meets the output projection in float32
    return ref.mm(o, p["wo"].float())

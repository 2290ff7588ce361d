"""Model configuration.

The fields are those of the reference package's ``ModelConfig``: the
dense decoder (GQA attention with RoPE: full, sliding-window or chunked,
optionally FULL every k-th layer; optional qk-norm and qkv bias; SwiGLU
and RMSNorm), the mixture-of-experts FFN (top-k routing with capacity, a
shared expert, MoE every k-th layer), the RWKV6 time-mix, Mamba's
selective scan in the hybrid stack (an attention slot every
``attn_every`` layers, Mamba in the others), the VLM's gated
cross-attention every ``cross_attn_every`` layers, and the parameters'
dtype.  Layers repeat as ``num_groups`` groups of ``group_size`` slots,
in the reference's parameter layout.

One field is the port's own: ``experts_held``, the share of an MoE
layer's experts that this card holds where expert parallelism splits
the layer over ``num_experts // experts_held`` cards (0, the default:
all of them).  The router still routes over every expert; the card
holds the first block of experts and computes only the pairs routed to
it (``moe.moe_ffn``).
"""
from __future__ import annotations

import dataclasses
import math

# layer-slot kinds
ATTN = "attn"
MAMBA = "mamba"
RWKV = "rwkv"

# layer patterns
MAMBA_HYBRID = "mamba_hybrid"

# attention kinds
FULL = "full"
SLIDING = "sliding"
CHUNKED = "chunked"

# the reference's arch types: "audio" (musicgen) is a plain decoder over
# codec tokens; "ssm" is RWKV6 (layer_pattern "rwkv"); "hybrid" is Jamba
# (layer_pattern "mamba_hybrid"); "vlm" a decoder with cross-attention
ARCH_TYPES = ("dense", "audio", "moe", "ssm", "hybrid", "vlm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str            # dense | audio | moe | ssm | hybrid | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0         # 0 -> d_model // num_heads

    # attention flavour
    attn_kind: str = FULL     # full | sliding | chunked
    window: int = 4096        # sliding-window size
    chunk: int = 8192         # chunked-attention chunk
    full_attn_every: int = 0  # >0: every k-th attention layer is FULL
    qk_norm: bool = False     # qwen3
    qkv_bias: bool = False    # qwen1.5
    rope_theta: float = 1e6

    # mixture of experts
    moe: bool = False
    num_experts: int = 0
    top_k: int = 2
    moe_every: int = 1        # MoE FFN on every k-th layer
    shared_expert: bool = False  # llama4
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    experts_held: int = 0     # this card's block of the experts; 0 -> all

    # recurrent mixers
    layer_pattern: str = ATTN  # attn | rwkv | mamba_hybrid
    attn_every: int = 0        # hybrid: an attention slot every k-th layer
    mamba_d_state: int = 16
    mamba_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0     # 0 -> ceil(d_model / 16)
    rwkv_head_dim: int = 64

    # vlm
    cross_attn_every: int = 0  # a cross-attention block every k-th layer
    num_image_tokens: int = 1601

    norm_eps: float = 1e-5
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    source: str = ""

    def __post_init__(self):
        if self.arch_type not in ARCH_TYPES:
            raise ValueError(f"{self.name}: arch_type {self.arch_type!r}")
        if self.layer_pattern not in (ATTN, RWKV, MAMBA_HYBRID):
            raise ValueError(
                f"{self.name}: layer_pattern {self.layer_pattern!r}")
        if self.layer_pattern == MAMBA_HYBRID and self.attn_every < 1:
            raise ValueError(f"{self.name}: mamba_hybrid needs attn_every")
        if self.attn_kind not in (FULL, SLIDING, CHUNKED):
            raise ValueError(f"{self.name}: attn_kind {self.attn_kind!r}")
        if self.num_heads % self.num_kv_heads:
            raise ValueError(f"{self.name}: {self.num_heads} heads do not "
                             f"share {self.num_kv_heads} kv heads evenly")
        if self.experts_held and not (
                self.moe and 0 < self.experts_held <= self.num_experts
                and self.num_experts % self.experts_held == 0):
            raise ValueError(f"{self.name}: experts_held "
                             f"{self.experts_held} is not a block of "
                             f"{self.num_experts} experts")
        if self.experts_held and self.shared_expert:
            # every card would add the shared expert to its share
            raise ValueError(f"{self.name}: experts_held with a shared "
                             "expert")

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def dt_rank(self) -> int:
        return self.mamba_dt_rank or -(-self.d_model // 16)

    @property
    def group_size(self) -> int:
        """Length of the repeating layer pattern."""
        g = 1
        if self.attn_every:
            g = math.lcm(g, self.attn_every)
        if self.cross_attn_every:
            g = math.lcm(g, self.cross_attn_every)
        if self.moe and self.moe_every > 1:
            g = math.lcm(g, self.moe_every)
        if self.full_attn_every:
            g = math.lcm(g, self.full_attn_every)
        return g

    @property
    def num_groups(self) -> int:
        if self.num_layers % self.group_size:
            raise ValueError(
                f"{self.name}: num_layers {self.num_layers} not divisible by "
                f"group_size {self.group_size}")
        return self.num_layers // self.group_size

    def slot_kind(self, slot: int) -> str:
        """Mixer kind of layer slot ``slot`` within a group: in the hybrid
        stack, attention on every ``attn_every``-th slot, Mamba on the
        others."""
        if self.layer_pattern == RWKV:
            return RWKV
        if self.layer_pattern == MAMBA_HYBRID:
            k = self.attn_every
            return ATTN if slot % k == k - 1 else MAMBA
        return ATTN

    def slot_has_cross(self, slot: int) -> bool:
        k = self.cross_attn_every
        return bool(k) and slot % k == k - 1

    def slot_is_moe(self, slot: int) -> bool:
        if not self.moe:
            return False
        return slot % self.moe_every == self.moe_every - 1

    def slot_attn_kind(self, slot: int) -> str:
        k = self.full_attn_every
        if k:
            return FULL if slot % k == k - 1 else self.attn_kind
        return self.attn_kind

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch hold a 500k context (long_500k eligibility)?
        RWKV6's state is O(1) and the hybrid's attention slots are
        sequence-sharded; otherwise sliding or chunked attention."""
        if self.layer_pattern in (RWKV, MAMBA_HYBRID):
            return True
        return self.attn_kind in (SLIDING, CHUNKED)

    def param_count(self) -> int:
        """Approximate global parameter count, unpadded and without norms
        or biases, exactly as the reference counts it (RWKV6's time-mix
        as 6 d^2).  With ``experts_held`` it is this card's: an MoE
        layer's held experts and its router (d E), which the reference's
        count leaves out."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim_
        n_q = self.num_heads * hd
        n_kv = self.num_kv_heads * hd
        total = 2 * V * d  # embed + lm head
        for slot in range(self.group_size):
            kind = self.slot_kind(slot)
            if kind == ATTN:
                mix = d * n_q + 2 * d * n_kv + n_q * d
            elif kind == RWKV:
                mix = 6 * d * d
            else:
                di = self.mamba_expand * d
                mix = (2 * d * di + di * d
                       + di * (2 * self.mamba_d_state + self.dt_rank))
            if self.slot_has_cross(slot):
                mix += d * n_q + 2 * d * n_kv + n_q * d
            if self.slot_is_moe(slot):
                ffp = (self.experts_held or self.num_experts) * 3 * d * ff
                if self.experts_held:
                    ffp += d * self.num_experts
                if self.shared_expert:
                    ffp += 3 * d * ff
            else:
                ffp = 3 * d * ff
            total += (mix + ffp) * self.num_groups
        return total

    def active_param_count(self) -> int:
        """Parameters a token touches: an MoE slot's top_k experts (and
        its shared expert) only; with ``experts_held``, the share of its
        top_k that this card holds on average, top_k * experts_held /
        num_experts."""
        total = self.param_count()
        if not self.moe:
            return total
        E, held = self.num_experts, self.experts_held or self.num_experts
        expert = 3 * self.d_model * self.d_ff
        unused = held * expert - self.top_k * held * expert // E
        for slot in range(self.group_size):
            if self.slot_is_moe(slot):
                total -= unused * self.num_groups
        return total

"""Model configuration.

The fields are those of the reference package's ``ModelConfig`` that the
port's families read: the dense decoder (GQA attention with RoPE: full,
sliding-window or chunked, optionally FULL every k-th layer; optional
qk-norm and qkv bias; SwiGLU and RMSNorm), the mixture-of-experts FFN
(top-k routing with capacity, a shared expert, MoE every k-th layer) and
the RWKV6 time-mix, with float32 parameters.  Layers repeat as
``num_groups`` groups of ``group_size`` slots, in the reference's
parameter layout.
"""
from __future__ import annotations

import dataclasses
import math

# layer-slot kinds
ATTN = "attn"
RWKV = "rwkv"

# attention kinds
FULL = "full"
SLIDING = "sliding"
CHUNKED = "chunked"

# arch types the port builds: "audio" (musicgen) is a plain decoder over
# codec tokens, as in the reference; "ssm" is RWKV6 (layer_pattern "rwkv")
ARCH_TYPES = ("dense", "audio", "moe", "ssm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str            # dense | audio | moe | ssm
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

    # recurrent mixers
    layer_pattern: str = ATTN  # attn | rwkv (mamba_hybrid: not yet)
    rwkv_head_dim: int = 64

    # vlm (not yet: a non-zero value is refused)
    cross_attn_every: int = 0

    norm_eps: float = 1e-5
    compute_dtype: str = "bfloat16"
    source: str = ""

    def __post_init__(self):
        if self.arch_type not in ARCH_TYPES:
            raise NotImplementedError(
                f"{self.name}: arch_type {self.arch_type!r} is not ported "
                "yet (ROADMAP section 1: Mamba and the hybrid stack are "
                "item 6, the VLM item 7)")
        if self.layer_pattern not in (ATTN, RWKV):
            raise NotImplementedError(
                f"{self.name}: layer_pattern {self.layer_pattern!r} is not "
                "ported yet (ROADMAP section 1 item 6)")
        if self.cross_attn_every:
            raise NotImplementedError(
                f"{self.name}: cross-attention is not ported yet (ROADMAP "
                "section 1 item 7)")
        if self.attn_kind not in (FULL, SLIDING, CHUNKED):
            raise ValueError(f"{self.name}: attn_kind {self.attn_kind!r}")
        if self.num_heads % self.num_kv_heads:
            raise ValueError(f"{self.name}: {self.num_heads} heads do not "
                             f"share {self.num_kv_heads} kv heads evenly")

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def group_size(self) -> int:
        """Length of the repeating layer pattern."""
        g = 1
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
        """Mixer kind of layer slot ``slot`` within a group."""
        return RWKV if self.layer_pattern == RWKV else ATTN

    def slot_is_moe(self, slot: int) -> bool:
        if not self.moe:
            return False
        return slot % self.moe_every == self.moe_every - 1

    def slot_attn_kind(self, slot: int) -> str:
        k = self.full_attn_every
        if k:
            return FULL if slot % k == k - 1 else self.attn_kind
        return self.attn_kind

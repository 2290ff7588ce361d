"""Model configuration.

The fields are those of the reference package's ``ModelConfig`` that the
dense decoder reads: the port runs the dense family (full causal GQA
attention, RoPE, SwiGLU, RMSNorm) with float32 parameters so far.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str            # the port runs "dense"
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0         # 0 -> d_model // num_heads
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    compute_dtype: str = "bfloat16"
    source: str = ""

    def __post_init__(self):
        if self.arch_type != "dense":
            raise NotImplementedError(
                f"{self.name}: the port runs dense decoders only so far")
        if self.num_heads % self.num_kv_heads:
            raise ValueError(f"{self.name}: {self.num_heads} heads do not "
                             f"share {self.num_kv_heads} kv heads evenly")

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

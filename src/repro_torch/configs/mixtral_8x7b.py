"""Mixtral-8x7B — MoE 8 experts top-2, GQA kv=8, sliding-window attention.
[arXiv:2401.04088]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", arch_type="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=32000,
    attn_kind="sliding", window=4096,
    moe=True, num_experts=8, top_k=2,
    rope_theta=1e6,
    source="arXiv:2401.04088 (Mixtral of Experts)",
)

SMOKE = ModelConfig(
    name="mixtral-smoke", arch_type="moe",
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
    d_ff=512, vocab_size=512,
    attn_kind="sliding", window=64,
    moe=True, num_experts=4, top_k=2,
    compute_dtype="float32",
    source="reduced mixtral-8x7b",
)

"""Jamba-1.5-Large 398B — hybrid Mamba+attention 7:1, MoE 16e top-2
every other layer. [arXiv:2403.19887]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", arch_type="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=24576, vocab_size=65536,
    layer_pattern="mamba_hybrid", attn_every=8,
    moe=True, num_experts=16, top_k=2, moe_every=2,
    mamba_d_state=16, mamba_conv=4, mamba_expand=2,
    # bf16 parameters, as the reference's config has them (398e9 of them)
    param_dtype="bfloat16",
    source="arXiv:2403.19887 (Jamba); 1.5-Large dims per assignment",
)

SMOKE = ModelConfig(
    name="jamba-smoke", arch_type="hybrid",
    num_layers=8, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=512,
    layer_pattern="mamba_hybrid", attn_every=8,
    moe=True, num_experts=4, top_k=2, moe_every=2,
    mamba_d_state=8, mamba_conv=4, mamba_expand=2,
    compute_dtype="float32",
    source="reduced jamba-1.5-large",
)

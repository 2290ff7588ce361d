"""Qwen3-0.6B — dense, GQA kv=8, qk_norm. [hf:Qwen/Qwen3-8B family]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", arch_type="dense",
    num_layers=28, d_model=1024, num_heads=16, num_kv_heads=8,
    d_ff=3072, vocab_size=151936,
    qk_norm=True, head_dim=128, rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B (qk_norm, GQA; 0.6B dims per assignment)",
)

SMOKE = ModelConfig(
    name="qwen3-smoke", arch_type="dense",
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
    d_ff=512, vocab_size=512, qk_norm=True, head_dim=64,
    compute_dtype="float32",
    source="reduced qwen3-0.6b",
)

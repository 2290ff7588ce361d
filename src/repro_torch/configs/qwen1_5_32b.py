"""Qwen1.5-32B — dense, GQA kv=40 (full MHA kv), QKV bias.
[hf:Qwen/Qwen1.5-0.5B family card, scaled per assignment]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", arch_type="dense",
    num_layers=64, d_model=5120, num_heads=40, num_kv_heads=40,
    d_ff=27392, vocab_size=152064,
    qkv_bias=True, rope_theta=1e6,
    source="hf:Qwen/Qwen1.5-0.5B (QKV bias; dims per assignment)",
)

SMOKE = ModelConfig(
    name="qwen1.5-smoke", arch_type="dense",
    num_layers=2, d_model=256, num_heads=8, num_kv_heads=8,
    d_ff=512, vocab_size=512, qkv_bias=True,
    compute_dtype="float32",
    source="reduced qwen1.5-32b",
)

"""Llama-3.2-1B: small dense llama3, GQA with 8 kv heads.
[hf:meta-llama/Llama-3.2-1B]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b", arch_type="dense",
    num_layers=16, d_model=2048, num_heads=32, num_kv_heads=8,
    d_ff=8192, vocab_size=128256,
    rope_theta=5e5,
    source="hf:meta-llama/Llama-3.2-1B",
)

SMOKE = ModelConfig(
    name="llama3.2-smoke", arch_type="dense",
    num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
    d_ff=512, vocab_size=512,
    compute_dtype="float32",
    source="reduced llama3.2-1b",
)

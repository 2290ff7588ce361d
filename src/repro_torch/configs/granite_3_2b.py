"""Granite-3.0-2B — dense, GQA kv=8. [hf:ibm-granite/granite-3.0-2b-base]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b", arch_type="dense",
    num_layers=40, d_model=2048, num_heads=32, num_kv_heads=8,
    d_ff=8192, vocab_size=49155,
    rope_theta=1e4,
    source="hf:ibm-granite/granite-3.0-2b-base",
)

SMOKE = ModelConfig(
    name="granite-smoke", arch_type="dense",
    num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
    d_ff=512, vocab_size=509,   # deliberately non-tp-divisible (padding path)
    compute_dtype="float32",
    source="reduced granite-3-2b",
)

"""RWKV6 "Finch" 7B — attention-free, data-dependent decay.
[arXiv:2404.05892]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", arch_type="ssm",
    num_layers=32, d_model=4096, num_heads=64, num_kv_heads=64,
    d_ff=14336, vocab_size=65536,
    layer_pattern="rwkv", rwkv_head_dim=64,
    source="arXiv:2404.05892 (RWKV-5/6: Eagle and Finch)",
)

SMOKE = ModelConfig(
    name="rwkv6-smoke", arch_type="ssm",
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
    d_ff=512, vocab_size=512,
    layer_pattern="rwkv", rwkv_head_dim=64,
    compute_dtype="float32",
    source="reduced rwkv6-7b",
)

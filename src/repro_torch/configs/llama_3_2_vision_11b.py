"""Llama-3.2-Vision-11B — dense decoder with gated cross-attention image
layers every 5th layer; vision frontend stubbed (precomputed patch
embeddings). [hf:meta-llama/Llama-3.2-11B-Vision]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", arch_type="vlm",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=128256,
    cross_attn_every=5, num_image_tokens=1601,
    rope_theta=5e5,
    source="hf:meta-llama/Llama-3.2-11B-Vision (cross-attn every 5th)",
)

SMOKE = ModelConfig(
    name="llama-vision-smoke", arch_type="vlm",
    num_layers=5, d_model=256, num_heads=4, num_kv_heads=2,
    d_ff=512, vocab_size=512,
    cross_attn_every=5, num_image_tokens=16,
    compute_dtype="float32",
    source="reduced llama-3.2-vision-11b",
)

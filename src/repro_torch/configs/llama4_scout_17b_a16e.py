"""Llama-4-Scout 17B-active / 16 experts top-1 + shared expert, chunked
attention (3 of 4 layers, chunk 8192) with full attention every 4th
(iRoPE); the text backbone.
[hf:meta-llama/Llama-4-Scout-17B-16E]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", arch_type="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048,
    attn_kind="chunked", chunk=8192, full_attn_every=4,
    moe=True, num_experts=16, top_k=1, shared_expert=True,
    rope_theta=5e5,
    source="hf:meta-llama/Llama-4-Scout-17B-16E (MoE top-1, chunked attn)",
)

SMOKE = ModelConfig(
    name="llama4-smoke", arch_type="moe",
    num_layers=4, d_model=256, num_heads=4, num_kv_heads=2,
    d_ff=512, vocab_size=512,
    attn_kind="chunked", chunk=64, full_attn_every=4,
    moe=True, num_experts=4, top_k=1, shared_expert=True,
    compute_dtype="float32",
    source="reduced llama4-scout",
)

"""MusicGen-Large — decoder-only transformer over EnCodec audio tokens;
the codec frontend is stubbed (token ids arrive precomputed).
[arXiv:2306.05284]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", arch_type="audio",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=2048,
    rope_theta=1e4,
    source="arXiv:2306.05284 (MusicGen; decoder over EnCodec tokens)",
)

SMOKE = ModelConfig(
    name="musicgen-smoke", arch_type="audio",
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
    d_ff=512, vocab_size=512,
    compute_dtype="float32",
    source="reduced musicgen-large",
)

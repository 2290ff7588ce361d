"""The paper's experimental scale transposed to this codebase: a small
dense model trained on the markov task (the quantizer is model-agnostic;
the paper used ResNets on CIFAR)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paper-proxy", arch_type="dense",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=256, vocab_size=256,
    compute_dtype="float32",
    source="paper Sec. 5 scale proxy",
)

SMOKE = CONFIG

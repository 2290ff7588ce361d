"""Architecture registry of the port: the configurations it can run."""
from . import (
    granite_3_2b,
    jamba_1_5_large_398b,
    llama3_2_1b,
    llama4_scout_17b_a16e,
    llama_3_2_vision_11b,
    mixtral_8x7b,
    musicgen_large,
    paper_mlp,
    qwen1_5_32b,
    qwen3_0_6b,
    rwkv6_7b,
)
from .shapes import SHAPES, InputShape, input_specs

_MODULES = {
    "rwkv6-7b": rwkv6_7b,
    "qwen1.5-32b": qwen1_5_32b,
    "jamba-1.5-large-398b": jamba_1_5_large_398b,
    "qwen3-0.6b": qwen3_0_6b,
    "llama-3.2-vision-11b": llama_3_2_vision_11b,
    "musicgen-large": musicgen_large,
    "mixtral-8x7b": mixtral_8x7b,
    "llama4-scout-17b-a16e": llama4_scout_17b_a16e,
    "granite-3-2b": granite_3_2b,
    "llama3.2-1b": llama3_2_1b,
    "paper-proxy": paper_mlp,
}

# the reference's architectures that the port builds
ARCH_NAMES = [n for n in _MODULES if n != "paper-proxy"]


def get_config(name: str):
    return _MODULES[name].CONFIG


def get_smoke_config(name: str):
    return _MODULES[name].SMOKE

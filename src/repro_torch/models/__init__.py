"""Decoder models of the port: the dense family, mixture-of-experts,
RWKV6, the Mamba hybrid and the VLM's cross-attention, in DP or FSDP
layout."""
from .config import ModelConfig
from .transformer import Model

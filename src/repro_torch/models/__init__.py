"""Decoder models of the port: the dense family, mixture-of-experts,
RWKV6, the Mamba hybrid and the VLM's cross-attention, in DP or FSDP
layout, on one rank or over a tensor-parallel model group."""
from .config import ModelConfig
from .layers import Dims, TPCtx, head_mask, make_dims, pad_to
from .transformer import Model

"""The four assigned input shapes and their stand-ins: tensors on the
``meta`` device, which carry a shape and a dtype and hold no memory (the
counterparts of the reference's ``jax.ShapeDtypeStruct``)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """Meta-device stand-ins for every model input (global shapes): the
    train batch's ids and labels, a prefill's ids, or a decode step's
    token and positions (the caches come separately), and a VLM's image
    embeddings in bfloat16."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind == "train":
        specs = {"ids": _spec((B, S), i32), "labels": _spec((B, S), i32)}
    elif shape.kind == "prefill":
        specs = {"ids": _spec((B, S), i32)}
    else:
        specs = {"token": _spec((B,), i32), "pos": _spec((B,), i32)}
    if cfg.cross_attn_every:
        specs["vision"] = _spec((B, cfg.num_image_tokens, cfg.d_model),
                                torch.bfloat16)
    return specs

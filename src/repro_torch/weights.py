"""Weight carry-over from the reference package's parameter tree.

``from_jax_params`` takes the tree that the reference's ``Model.init``
returns (``param_mode="dp"``, tp=1), already converted to numpy arrays,
and lays it out as the port's flat parameter vector.  Nothing of JAX is
needed: the tree is plain nested dicts and lists of arrays.  numpy has
no bfloat16, so a bfloat16 tree comes as float32 arrays (which hold
bfloat16 values exactly) and is cast to the config's ``param_dtype``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import param_layout


def from_jax_params(np_tree, cfg: ModelConfig) -> torch.Tensor:
    """Nested dict/list of numpy arrays -> flat (d,) CPU tensor of the
    config's ``param_dtype``, in the reference's ravel order
    (``Model.load_flat`` takes it)."""
    parts = []
    for name, shape, _ in param_layout(cfg):
        node = np_tree
        for key in name.split("."):
            node = node[int(key)] if isinstance(node, list) else node[key]
        arr = np.asarray(node, dtype=np.float32)
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape}, expected {shape}")
        parts.append(arr.reshape(-1))
    flat = torch.from_numpy(np.concatenate(parts))
    return flat.to(getattr(torch, cfg.param_dtype))

"""Weight and cache carry-over from the reference package's trees.

``from_jax_params`` takes the tree that the reference's ``Model.init``
returns (``param_mode="dp"``, tp=1), already converted to numpy arrays,
and lays it out as the port's flat parameter vector.  Nothing of JAX is
needed: the tree is plain nested dicts and lists of arrays.  numpy has
no bfloat16, so a bfloat16 tree comes as float32 arrays (which hold
bfloat16 values exactly) and is cast to the config's ``param_dtype``.
``from_jax_caches`` does the same for the decode caches that the
reference's ``Model.prefill`` returns.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ATTN, ModelConfig
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


def from_jax_caches(np_caches, cfg: ModelConfig) -> list:
    """The reference's decode caches (one (a, b) pair of numpy arrays a
    layer slot, stacked over the groups; tp = 1, one cache shard) -> the
    port's CPU tensors in the same layout: attention's k and v, RWKV6's
    prev_x and Mamba's conv inputs in the compute dtype, the recurrent
    states float32."""
    cd = getattr(torch, cfg.compute_dtype)
    out = []
    for slot, (a, b) in enumerate(np_caches):
        first = cd if cfg.slot_kind(slot) == ATTN else torch.float32
        out.append(tuple(torch.from_numpy(np.array(t, np.float32)).to(dt)
                         for t, dt in ((a, first), (b, cd))))
    return out

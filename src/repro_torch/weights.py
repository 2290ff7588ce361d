"""Weight and cache carry-over from the reference package's trees.

``from_jax_params`` takes the tree that the reference's ``Model.init``
returns (``param_mode="dp"``, tp=1), already converted to numpy arrays,
and lays it out as the port's flat parameter vector.  Nothing of JAX is
needed: the tree is plain nested dicts and lists of arrays.  numpy has
no bfloat16, so a bfloat16 tree comes as float32 arrays (which hold
bfloat16 values exactly) and is cast to the config's ``param_dtype``.
``from_jax_caches`` does the same for the decode caches that the
reference's ``Model.prefill`` returns, and ``from_jax_fsdp_params`` for
the reference's FSDP tree (``param_mode="fsdp"``), which goes to the
port's global FSDP flat (``Model.load_flat`` of an FSDP model keeps its
local shards).  ``dp_to_fsdp``/``fsdp_to_dp`` convert between the two
flats, so that one set of weights drives both modes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ATTN, ModelConfig
from repro_torch.models import transformer
from repro_torch.models.transformer import (  # noqa: F401  (re-exported)
    dp_to_fsdp, fsdp_to_dp, param_layout)


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


def from_jax_fsdp_params(np_tree, cfg: ModelConfig, bucket_size: int,
                         M: int) -> torch.Tensor:
    """The reference's FSDP tree (``embed``/``lm_head`` (1, Lp), the
    replicated ``final_norm``, ``slots`` a list of (num_groups, 1, Lp)),
    as numpy, for M workers and buckets of ``bucket_size`` -> the global
    FSDP flat (d_fsdp,) CPU tensor of the config's ``param_dtype``."""
    parts = []
    for e in transformer.fsdp_layout(cfg, bucket_size, M):
        node = np_tree
        for key in e.name.split("."):
            node = node[int(key)] if isinstance(node, list) else node[key]
        arr = np.asarray(node, dtype=np.float32)
        want = (e.Lp,) if e.meta is None else (
            (e.count, 1, e.Lp) if e.name.startswith("slots.") else (1, e.Lp))
        if arr.shape != want:
            raise ValueError(f"{e.name}: shape {arr.shape}, expected {want}")
        parts.append(arr.reshape(-1))
    flat = torch.from_numpy(np.concatenate(parts))
    return flat.to(getattr(torch, cfg.param_dtype))


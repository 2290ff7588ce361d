"""Weight and cache carry-over from the reference package's trees.

``from_jax_params`` takes the tree that the reference's ``Model.init``
returns (``param_mode="dp"``), already converted to numpy arrays, and
lays it out as the port's flat parameter vector; at tp > 1, that of one
rank of the model group (the reference stacks the ranks' shards along a
tp axis: ``embed`` and ``lm_head`` (tp, ...), a slot's leaves
(num_groups, tp, ...)).  Nothing of JAX is
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


def _ravel(np_tree, cfg: ModelConfig, tp: int,
           fsdp: tuple[int, int] | None = None) -> torch.Tensor:
    """The reference's tree at ``tp`` -> its global flat float32 CPU
    tensor (``transformer.to_global``'s layout), each leaf checked
    against its global shape."""
    parts = []
    for name, shape, _ in transformer.global_pieces(cfg, tp, fsdp):
        node = np_tree
        for key in name.split("."):
            node = node[int(key)] if isinstance(node, list) else node[key]
        arr = np.asarray(node, dtype=np.float32)
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape}, expected {shape}")
        parts.append(arr.reshape(-1))
    return torch.from_numpy(np.concatenate(parts))


def from_jax_params(np_tree, cfg: ModelConfig, tp: int = 1, rank: int = 0
                    ) -> torch.Tensor:
    """Nested dict/list of numpy arrays (the reference's tree at ``tp``)
    -> flat (d,) CPU tensor of the config's ``param_dtype`` of model rank
    ``rank``, in the reference's ravel order (``Model.load_flat`` takes
    it)."""
    flat = transformer.from_global(_ravel(np_tree, cfg, tp), cfg, tp, rank)
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
                         M: int, tp: int = 1, rank: int = 0
                         ) -> torch.Tensor:
    """The reference's FSDP tree (``embed``/``lm_head`` (tp, Lp), the
    replicated ``final_norm``, ``slots`` a list of (num_groups, tp, Lp)),
    as numpy, for M workers and buckets of ``bucket_size`` -> model rank
    ``rank``'s global FSDP flat (d_fsdp,) CPU tensor of the config's
    ``param_dtype`` (its flats whole over the M workers)."""
    fsdp = (bucket_size, M)
    flat = transformer.from_global(_ravel(np_tree, cfg, tp, fsdp), cfg, tp,
                                   rank, fsdp=fsdp)
    return flat.to(getattr(torch, cfg.param_dtype))

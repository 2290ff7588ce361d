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
``from_jax_caches`` cuts the decode caches that the reference's
``Model.prefill`` and ``decode`` return (global, as its ``shard_map``
gives them) to one rank's.  ``from_jax_fsdp_params`` takes the
reference's FSDP tree (``param_mode="fsdp"``) to the port's global FSDP
flat (``Model.load_flat`` of an FSDP model keeps its
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


def from_jax_caches(np_caches, cfg: ModelConfig, tp: int = 1, rank: int = 0,
                    cache_shards: int = 1, shard_id: int = 0) -> list:
    """The reference's decode caches in its global layout (one (a, b) pair
    of numpy arrays a layer slot, stacked over the groups: the outputs of
    its ``shard_map``-ped prefill or decode under ``cache_pspecs``) ->
    the CPU tensors one rank holds (``transformer.cache_layout``):
    attention's k and v cut to sequence shard ``shard_id`` of
    ``cache_shards``, RWKV6's state and Mamba's state and conv inputs to
    model rank ``rank``'s heads or channels of ``tp``; attention's k and
    v, RWKV6's prev_x and Mamba's conv inputs in the compute dtype, the
    recurrent states float32.  The batch is not cut."""
    cd = getattr(torch, cfg.compute_dtype)
    layout = transformer.cache_layout(cfg, seq_shard_axes=("seq",))
    part = {("model",): (tp, rank), ("seq",): (cache_shards, shard_id)}.get
    out = []
    for slot, (leaves, specs) in enumerate(zip(np_caches, layout)):
        first = cd if cfg.slot_kind(slot) == ATTN else torch.float32
        out.append(tuple(
            transformer.narrow_to(torch.from_numpy(np.array(t, np.float32)),
                                  spec, part).to(dt).contiguous()
            for t, spec, dt in zip(leaves, specs, (first, cd))))
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

"""Serving engine: a batched prefill step and a one-token decode step,
each picking the next token by argmax of the float32 logits.

The caches are each rank's: attention's ring of ``C`` slots a layer
(``attention.cache_spec``), sequence-sharded over ``cache_shards`` ranks
(the reference's serve launcher passes tp), RWKV6's and Mamba's
recurrent states sharded over the model group (``Model.init_cache`` and
``Model.cache_layout`` give the layout), in the model's compute dtype
(the reference's ``cache_dtype`` field, which its own steps never read,
is left out).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.transformer import Model


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int = 4096           # positions the caches hold (prompt + gen)
    greedy: bool = True
    temperature: float = 1.0


def make_prefill_step(model: Model, scfg: ServeConfig, *,
                      cache_shards: int = 1):
    """``prefill_step(ids (B, S), vision=None)`` -> (the next token (B,)
    int32, the caches, attention's in ``cache_shards`` sequence
    shards)."""
    def prefill_step(ids: torch.Tensor, vision: torch.Tensor | None = None):
        logits, caches = model.prefill(ids, vision, max_len=scfg.max_len,
                                       cache_shards=cache_shards)
        return torch.argmax(logits, dim=-1).to(torch.int32), caches

    return prefill_step


def make_decode_step(model: Model, scfg: ServeConfig, *,
                     cache_shards: int | None = None):
    """``decode_step(token (B,), pos (B,), caches, vision=None)`` -> (the
    next token (B,) int32, the caches, updated in place).  Without
    ``greedy`` it takes the argmax of logits / temperature, which is the
    same token: the reference's behaviour, kept.  ``cache_shards`` None
    takes ``Model.decode``'s default (the ``seq_shard_axes`` groups'
    sizes multiplied)."""
    def decode_step(token: torch.Tensor, pos: torch.Tensor, caches: list,
                    vision: torch.Tensor | None = None):
        logits, caches = model.decode(token, pos, caches, vision,
                                      cache_shards=cache_shards)
        if not scfg.greedy:
            logits = logits / scfg.temperature
        return torch.argmax(logits, dim=-1).to(torch.int32), caches

    return decode_step

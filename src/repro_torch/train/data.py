"""Data pipeline: deterministic host-side token batches.

The same numpy generator as the reference package's pipeline, so a seed
gives identical batches in both packages; batches come back as int64
tensors on the requested device.

  * ``markov``: sequences from a fixed random bigram table, a learnable
    synthetic LM task (its V x V table limits it to small vocabularies);
  * ``uniform``: i.i.d. uniform tokens (throughput filler).

``vision_stub`` gives the VLM's stand-in image embeddings from the same
seeded stream as the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    kind: str = "markov"        # markov | uniform
    vocab_size: int = 256
    seq_len: int = 128
    global_batch: int = 8
    seed: int = 0
    markov_temperature: float = 0.5


class Pipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.table = None
        if cfg.kind == "markov":
            rng = np.random.default_rng(cfg.seed)
            logits = rng.standard_normal((cfg.vocab_size, cfg.vocab_size))
            logits /= cfg.markov_temperature
            p = np.exp(logits - logits.max(-1, keepdims=True))
            self.table = (p / p.sum(-1, keepdims=True)).astype(np.float64)
        elif cfg.kind != "uniform":
            raise ValueError(f"unknown data kind {cfg.kind!r}")

    def tokens(self, step: int) -> np.ndarray:
        """(B, S + 1) int32 tokens of batch ``step``."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, 0xD1CE]))
        B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        if cfg.kind == "uniform":
            return rng.integers(0, V, size=(B, S + 1), dtype=np.int32)
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.integers(0, V, size=B)
        u = rng.random((B, S))
        cdf = np.cumsum(self.table, axis=-1)
        for t in range(S):
            toks[:, t + 1] = np.argmax(u[:, t, None] < cdf[toks[:, t]], axis=-1)
        return toks

    def batch(self, step: int, device="cuda") -> dict[str, torch.Tensor]:
        """dict(ids (B, S), labels (B, S)) as int64 tensors."""
        toks = torch.from_numpy(self.tokens(step)).to(device=device,
                                                      dtype=torch.int64)
        return {"ids": toks[:, :-1], "labels": toks[:, 1:]}

    def vision_stub(self, num_tokens: int, d_model: int, step: int,
                    device="cuda") -> torch.Tensor:
        """(B, num_tokens, d_model) float32 standard-normal embeddings of
        batch ``step``: the precomputed patch embeddings that stand in
        for the VLM's image frontend."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, 0xFACE]))
        x = rng.standard_normal(
            (cfg.global_batch, num_tokens, d_model)).astype(np.float32)
        return torch.from_numpy(x).to(device)

"""Collective transport for the quantized sync engine.

``dist.sync`` runs its wire modes against this small interface, so the
same ENCODE -> collective -> DECODE code serves any way of moving
payloads.  ``StackedTransport`` holds M logical workers on one device:
every per-worker tensor carries a leading worker axis M, a gather is a
``torch.stack`` and the cross-worker mean is ``mean(0)``.  It is the
counterpart of the reference's vmap-axis transport, which its cluster
simulator uses to run M workers on one host.
"""
from __future__ import annotations

import torch


class StackedTransport:
    """M logical workers on one device, stacked along axis 0."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"need at least one worker, got {size}")
        self._size = size

    def size(self) -> int:
        return self._size

    def all_gather(self, per_worker: list[torch.Tensor]) -> torch.Tensor:
        """M per-worker tensors -> (M, ...) with worker w's at row w."""
        if len(per_worker) != self._size:
            raise ValueError(f"expected {self._size} payloads, "
                             f"got {len(per_worker)}")
        return torch.stack(per_worker)

    def mean_workers(self, stacked: torch.Tensor) -> torch.Tensor:
        """Mean over the leading (worker) axis: sum, then divide, the
        reduction order the reference's wire contract pins."""
        return stacked.mean(0)

    def mean_psum(self, stacked: torch.Tensor) -> torch.Tensor:
        """fp32 mean-allreduce of per-worker local values (M, ...)."""
        return stacked.mean(0)

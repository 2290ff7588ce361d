"""Collective transport for the quantized sync engine.

``dist.sync`` runs its wire modes against this small interface, so the
same ENCODE -> collective -> DECODE code serves any way of moving
payloads.  A transport holds ``local_workers()``, the global indices of
the workers whose tensors this process holds, and every per-worker
argument is a list (or leading axis) over them, in that order; what a
collective returns covers all M workers.

``StackedTransport`` holds all M logical workers on one device: a gather
is a ``torch.stack`` and the cross-worker mean is ``mean(0)``.  It is the
counterpart of the reference's vmap-axis transport, which its cluster
simulator uses to run M logical workers on one host.
``ProcessGroupTransport`` holds one worker a process and moves the words
with ``torch.distributed`` collectives: the counterpart of the
reference's ``MeshTransport`` over the data axes.

A transport also owns the cross-worker averaging rule: the plain
transport averages uniformly; ``MaskedTransport`` renormalizes over the
workers whose payloads arrived (the simulator's dropout hook), so every
wire mode gets dropout support without knowing about it.  A codec that
decodes and averages in one pass asks ``mean_weights`` which weights the
rule uses (None for the plain mean, sum then divide), so the sync engine
never needs to know which transport it holds.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _weighted_sum(weights: torch.Tensor, stacked: torch.Tensor
                  ) -> torch.Tensor:
    """sum_m weights[m] * stacked[m], in worker order: the one weighted
    reduction both masked means use, so that they agree bit for bit."""
    out = weights[0] * stacked[0]
    for m in range(1, stacked.shape[0]):
        out += weights[m] * stacked[m]
    return out


class StackedTransport:
    """M logical workers on one device, stacked along axis 0."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"need at least one worker, got {size}")
        self._size = size

    def size(self) -> int:
        return self._size

    def local_workers(self) -> list[int]:
        """The global indices of the workers this process holds."""
        return list(range(self._size))

    def all_gather(self, per_worker: list[torch.Tensor]) -> torch.Tensor:
        """M per-worker tensors -> (M, ...) with worker w's at row w."""
        if len(per_worker) != self._size:
            raise ValueError(f"expected {self._size} payloads, "
                             f"got {len(per_worker)}")
        return torch.stack(per_worker)

    def all_to_all(self, per_worker: list[torch.Tensor]) -> torch.Tensor:
        """M per-worker (M, ...) payloads, row j bound for worker j ->
        (M, M, ...) whose [r, w] is what worker w sent to worker r."""
        if len(per_worker) != self._size:
            raise ValueError(f"expected {self._size} payloads, "
                             f"got {len(per_worker)}")
        return torch.stack(per_worker, dim=1)

    # ---- aggregation rule ------------------------------------------------

    def active_vector(self) -> torch.Tensor:
        """(M,) raw per-worker delivery weights before renormalization
        (all 1 here)."""
        return torch.ones(self._size, dtype=torch.float32)

    def weights(self) -> torch.Tensor:
        """(M,) convex weights used to average per-worker payloads."""
        return torch.full((self._size,), 1.0 / self._size,
                          dtype=torch.float32)

    def mean_weights(self, valid: torch.Tensor | None = None
                     ) -> torch.Tensor | None:
        """The weights of this transport's mean: None for the plain mean
        (sum, then divide by M); with an (M, nb) bool ``valid`` the (M,
        nb) weights of ``mean_workers_bucketed``, on its device."""
        if valid is None:
            return None
        a = (self.active_vector().to(valid.device)[:, None]
             * valid.to(torch.float32))
        return a / torch.clamp(a.sum(0), min=1.0)

    def mean_workers(self, stacked: torch.Tensor) -> torch.Tensor:
        """Mean over the leading (worker) axis: sum, then divide, the
        reduction order the reference's wire contract pins."""
        return stacked.mean(0)

    def mean_workers_bucketed(self, stacked: torch.Tensor,
                              valid: torch.Tensor,
                              bucket_size: int) -> torch.Tensor:
        """Per-bucket masked mean over workers of (M, n) values, with
        ``valid`` an (M, nb) bool mask of the buckets that passed the
        integrity checks.  Invalid buckets are excluded and the rest
        renormalized per bucket by ``MaskedTransport.weights``'s formula
        (``a / max(sum(a), 1)`` of the raw active vector), so a worker
        whose every bucket is invalid aggregates exactly like one masked
        out at the transport.  An all-invalid bucket gives 0.
        """
        M, nb = valid.shape
        w = self.mean_weights(valid)                            # (M, nb)
        # a corrupt bucket may decode to NaN or inf, and 0 * NaN = NaN:
        # zero its values as well as its weight
        vb = stacked.reshape(M, nb, bucket_size)
        vb = torch.where(valid[:, :, None], vb, 0.0)
        return _weighted_sum(w[:, :, None], vb).reshape(-1)

    def mean_psum(self, stacked: torch.Tensor) -> torch.Tensor:
        """fp32 mean-allreduce of per-worker local values (M, ...)."""
        return stacked.mean(0)

    def reduce_scatter_mean(self, rows: torch.Tensor) -> torch.Tensor:
        """The local workers' (L, n) rows -> (L, n/M): local worker i's
        shard (the i-th of M equal slices) of the mean over all M
        workers' rows, the reference's ``psum_scatter / M``."""
        M = self._size
        return rows.view(M, M, rows.shape[1] // M).mean(0)


class MaskedTransport(StackedTransport):
    """Stacked workers with an injected per-worker weight vector, the
    simulator's dropout / heterogeneity hook.

    ``active`` is an (M,) float vector (1 = payload arrives, 0 = worker
    absent); weights renormalize over the survivors, so the aggregate is
    the mean over the workers whose payloads were delivered.
    """

    def __init__(self, active: torch.Tensor):
        active = torch.as_tensor(active, dtype=torch.float32)
        super().__init__(active.shape[0])
        self.active = active

    def active_vector(self) -> torch.Tensor:
        return self.active

    def weights(self) -> torch.Tensor:
        return self.active / torch.clamp(self.active.sum(), min=1.0)

    def mean_weights(self, valid=None):
        """``weights()`` for the plain mean; per bucket under ``valid``."""
        if valid is None:
            return self.weights()
        return super().mean_weights(valid)

    def mean_workers(self, stacked: torch.Tensor) -> torch.Tensor:
        w = self.weights().to(stacked.device)
        return _weighted_sum(w.reshape((-1,) + (1,) * (stacked.dim() - 1)),
                             stacked)

    def mean_psum(self, stacked: torch.Tensor) -> torch.Tensor:
        return self.mean_workers(stacked)


class ProcessGroupTransport(StackedTransport):
    """One worker a process over a ``torch.distributed`` process group.

    Worker w is the process of global rank w.  NCCL gathers into one
    tensor (``all_gather_into_tensor``), gloo into the rows of one
    (``all_gather``); both exchange shards with ``all_to_all_single``.
    Words travel as the int32 bit patterns they are.  The averaging rule
    acts on gathered rows as the stacked transport's does, so every
    process holds the aggregate the stacked workers would.
    """

    def __init__(self, group=None):
        super().__init__(dist.get_world_size(group))
        self.group = group
        self._rank = dist.get_rank(group)
        self.backend = dist.get_backend(group)

    def rank(self) -> int:
        return self._rank

    def local_workers(self) -> list[int]:
        return [self._rank]

    @staticmethod
    def _own(per_worker) -> torch.Tensor:
        if len(per_worker) != 1:
            raise ValueError(f"a process holds one worker, got "
                             f"{len(per_worker)} payloads")
        return per_worker[0].contiguous()

    def all_gather(self, per_worker: list[torch.Tensor]) -> torch.Tensor:
        """This process's payload -> (M, ...) with rank w's at row w."""
        x = self._own(per_worker)
        out = x.new_empty((self._size,) + x.shape)
        if self.backend == dist.Backend.NCCL:
            dist.all_gather_into_tensor(out, x, group=self.group)
        else:
            dist.all_gather(list(out), x, group=self.group)
        return out

    def all_to_all(self, per_worker: list[torch.Tensor]) -> torch.Tensor:
        """This process's (M, ...) payload, row j bound for rank j ->
        (1, M, ...) whose [0, w] is what rank w sent to this one."""
        x = self._own(per_worker)
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        return out[None]

    def reduce_scatter_mean(self, rows: torch.Tensor) -> torch.Tensor:
        """This process's (1, n) row -> (1, n/M), its shard of the mean:
        an ``all_to_all_single`` of the M slices (gloo has no
        reduce-scatter), then the mean of the M received slices."""
        x = self._own(rows).view(self._size, -1)
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        return out.mean(0)[None]

    def mean_psum(self, stacked: torch.Tensor) -> torch.Tensor:
        """The reference's ``psum / size`` of this process's (1, ...)
        row: a float32 sum over the ranks, divided, in the row's dtype."""
        total = self._own(stacked).to(torch.float32, copy=True)
        dist.all_reduce(total, group=self.group)
        return (total / self._size).to(stacked.dtype)


def make_transport(size: int, active: torch.Tensor | None = None
                   ) -> StackedTransport:
    """The transport ``quantized_allreduce`` uses by default."""
    if active is not None:
        return MaskedTransport(active)
    return StackedTransport(size)

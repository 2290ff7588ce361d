"""Adaptive quantized data-parallel train step (Algorithm 1, end to end)
for M data-parallel workers: all M on one device over the stacked
transport, or one a process over a ``ProcessGroupTransport``.

Per step:
  1. each worker the process holds runs forward and backward on its
     contiguous rows of the global batch (and of its ``vision``
     embeddings, where the batch has them), and its gradient lands in its
     row of one (L, d) buffer of the parameters' dtype, L the local
     workers (the model's parameters and gradients are flat views, in the
     reference's ravel order); with ``microbatches=k`` the rows run as k
     consecutive micro-batches whose gradients accumulate in that row, in
     the parameters' dtype as in the reference;
  2. on the update schedule: bucket statistics per worker, the merged
     mixture, and the ALQ/AMQ level update (lines 2-4);
  3. ENCODE -> collective -> DECODE -> average (lines 6-9) through
     ``dist.sync.compressed_allreduce``, with the configured compression
     algorithm around the wire (the error-feedback residual is formed in
     place in the gradient rows and updated worker by worker); bfloat16
     rows go to the wire as float32, whose values they hold exactly, as
     the reference's quantizer reads them, and the decoded aggregate is
     float32; the plain mean (``fp32``, or an unquantized scheme) keeps
     the rows' dtype, as the reference's ``psum`` does;
  4. one SGD-momentum / AdamW update of the flat parameters from the
     aggregate, with moments in the aggregate's dtype (as the reference's
     are after its first step) and parameters rounded back to theirs.

``Trainer.state_arrays`` / ``load_state_arrays`` give its whole state as
named tensors for ``train.checkpoint``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.compress import make_algorithm
from repro_torch.core.codec import make_codec
from repro_torch.core.schemes import QuantScheme, SchemeState
from repro_torch.dist.sync import (
    compressed_allreduce, maybe_update_levels, quantized_allreduce)
from repro_torch.dist.transport import StackedTransport
from repro_torch.models.transformer import Model
from repro_torch.timing import NO_CLOCK
from .optim import OptimConfig, OptState, apply_updates, init_opt_state


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    scheme: QuantScheme = QuantScheme()
    optim: OptimConfig = OptimConfig()
    sync_mode: str = "all_gather"       # fp32 | all_gather | two_phase
    update_milestones: tuple = (100, 2000)
    update_every: int = 10_000          # additionally every k steps
    workers: int = 1                    # M logical data-parallel workers
    microbatches: int = 1               # gradient accumulation per worker
    # wire codec: 'uniform' | 'mixed_width' | 'entropy[:base]' (the
    # entropy-coded wire with the gaussian-prior table; its bits/coord
    # are then the measured coded volume)
    codec: str = "uniform"
    # per-bucket scheme-bits pattern of codec='mixed_width', tiled over
    # the buckets; empty = the budget-neutral (bits-1, bits+1) cycle
    mixed_width_pattern: tuple = ()
    # compression algorithm around the codec (repro_torch.compress):
    # 'plain' | 'ef[:warmup_steps]' | 'topk[:k]'
    compress: str = "plain"
    # per-bucket checksum words on the wire; corrupt buckets are excluded
    integrity: bool = False


def _make_algo(tcfg: TrainConfig):
    if not tcfg.scheme.quantized:
        return None
    # None = the scheme's uniform codec; only another codec or an
    # integrity plan is passed explicitly (make_algorithm refuses a codec
    # for 'topk', which owns its SparseCodec)
    codec = None
    if tcfg.codec != "uniform" or tcfg.integrity:
        codec = make_codec(tcfg.scheme, tcfg.codec, tcfg.mixed_width_pattern,
                           integrity=tcfg.integrity)
    return make_algorithm(tcfg.compress, tcfg.scheme, codec=codec)


# domain separation of the per-worker rounding seeds
_FOLD_WORKER = 0x57A7


def worker_seed(seed: int, w: int) -> int:
    """The seed of worker w's rounding generator: (seed, w) -> a 63-bit
    int, the counterpart of the reference's ``fold_in(key, rank)``."""
    ss = np.random.SeedSequence([seed, _FOLD_WORKER, w])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def is_update_step(tcfg: TrainConfig, step: int) -> bool:
    if step in tcfg.update_milestones:
        return True
    return tcfg.update_every > 0 and step > 0 and step % tcfg.update_every == 0


class Trainer:
    """Owns the training state of one model for the workers its process
    holds (``transport.local_workers()``; all ``tcfg.workers`` on the
    default stacked transport): their (L, d) gradient rows, the optimizer
    moments, the scheme state, the compression state (their (L, d)
    error-feedback residual rows of a stateful algorithm), their rounding
    generators and the step counter.

    Worker w's stochastic rounding draws from its own generator on the
    model's device, seeded with ``worker_seed(seed, w)``, so a worker
    draws the same uniforms whichever process holds it.
    """

    def __init__(self, model: Model, tcfg: TrainConfig, *, seed: int = 0,
                 transport: StackedTransport | None = None):
        self.model = model
        self.tcfg = tcfg
        if transport is None:
            transport = StackedTransport(tcfg.workers)
        if transport.size() != tcfg.workers:
            raise ValueError(f"a transport of {transport.size()} workers "
                             f"for {tcfg.workers}")
        self.transport = transport
        self.local = transport.local_workers()
        dev = model.flat.device
        self.grads = torch.zeros((len(self.local), model.d),
                                 dtype=model.flat.dtype, device=dev)
        # the wire decodes to float32; the plain mean keeps the rows' dtype
        self.plain_mean = (tcfg.sync_mode == "fp32"
                           or not tcfg.scheme.quantized)
        self.opt = init_opt_state(
            tcfg.optim, model.flat,
            model.flat.dtype if self.plain_mean else torch.float32)
        self.scheme_state = tcfg.scheme.init_state(dev)
        self.algo = _make_algo(tcfg)
        self.compress_state = None
        if self.algo is not None and self.algo.stateful:
            self.compress_state = self.algo.init_state(len(self.local),
                                                       model.d, dev)
        self.step = 0
        self.generators = [
            torch.Generator(device=dev).manual_seed(worker_seed(seed, w))
            for w in self.local]

    def train_step(self, batch: dict[str, torch.Tensor], *,
                   u: Sequence[torch.Tensor] | None = None,
                   u2: Sequence[torch.Tensor] | None = None,
                   clock=NO_CLOCK) -> dict[str, float]:
        """One step on a global batch (ids, labels of shape (B, S), and
        for a VLM optionally ``vision`` of shape (B, S_img, d_model)).

        ``u`` and ``u2`` optionally give each local worker's uniforms
        (see ``quantized_allreduce``).  Returns the step's metrics, the
        same in every process: the loss is the mean of all M workers'
        losses, per-worker wire metrics are worker 0's, the residual norm
        the workers' mean.
        """
        tcfg, model = self.tcfg, self.model
        M = tcfg.workers
        B = batch["ids"].shape[0]
        if B % M:
            raise ValueError(f"global batch {B} does not split over {M} "
                             "workers")
        rows = B // M
        k = tcfg.microbatches
        if rows % k:
            raise ValueError(f"{rows} rows a worker do not split into {k} "
                             "micro-batches")
        mb = rows // k
        vision = batch.get("vision")
        losses = []
        for i, w in enumerate(self.local):
            g = self.grads[i]
            g.zero_()
            model.attach_grads(g)
            loss = 0.0
            for i in range(w * rows, (w + 1) * rows, mb):
                part = model.loss(
                    batch["ids"][i:i + mb], batch["labels"][i:i + mb],
                    None if vision is None else vision[i:i + mb])
                part.backward()     # accumulates into the worker's row
                loss = loss + part.detach()
            if k > 1:
                g.div_(k)
                loss = loss / k
            losses.append(loss)
        clock.mark("grad")
        # float32 rows are the same tensor
        rows = self.grads if self.plain_mean else self.grads.float()
        self.scheme_state = maybe_update_levels(
            rows, tcfg.scheme, self.scheme_state,
            is_update_step(tcfg, self.step), transport=self.transport,
            clock=clock)
        if self.algo is None:   # fp32 / super_sgd: the plain mean
            synced, m = quantized_allreduce(
                rows, tcfg.scheme, self.scheme_state,
                mode=tcfg.sync_mode, transport=self.transport, clock=clock)
        else:
            synced, self.compress_state, m = compressed_allreduce(
                rows, tcfg.scheme, self.scheme_state, self.algo,
                self.compress_state, mode=tcfg.sync_mode,
                transport=self.transport, u=u, u2=u2,
                generator=self.generators, clock=clock)
        grad_norm = torch.sqrt(torch.sum(synced * synced))
        self.opt = apply_updates(tcfg.optim, model.flat, synced, self.opt)
        del synced, rows
        clock.mark("optimizer")
        self.step += 1
        # every worker's loss, in worker order, in every process
        losses = self.transport.all_gather(losses)
        return {
            "loss": losses.mean().item(),
            "grad_norm": grad_norm.item(),
            "comm_bits_per_coord": m.comm_bits_per_coord,
            "quant_error": m.quant_error[0].item(),
            "reduce_bits_per_coord": m.reduce_bits_per_coord,
            "broadcast_bits_per_coord": m.broadcast_bits_per_coord,
            "entropy_bits_per_coord": float(m.entropy_bits_per_coord),
            "residual_norm": m.residual_norm.mean().item(),
            "kept_fraction": m.kept_fraction,
            "corrupt_fraction": m.corrupt_fraction[0].item(),
            "excluded_workers": m.excluded_workers[0].item(),
        }

    # ---- checkpointing ---------------------------------------------------

    def _all_rows(self, local: torch.Tensor) -> torch.Tensor:
        """The local workers' (L, ...) rows -> all M workers' (M, ...) on
        ``local``'s device; a collective when other processes hold
        workers."""
        if len(self.local) == self.transport.size():
            return local
        dev = self.model.flat.device
        return self.transport.all_gather(
            [r.to(dev) for r in local]).to(local.device)

    def state_arrays(self) -> dict[str, torch.Tensor]:
        """The whole training state as named tensors: flat parameters,
        optimizer moments and count, the scheme state, the step, every
        worker's rounding generator state (``worker_rng``, (M, state
        bytes)) and the compression state (``compress.residual``, all M
        workers' rows).  The same in every process, and the same as a
        stacked trainer's of the same M: a collective when other
        processes hold workers, so every process calls it."""
        out = {"params": self.model.flat.detach(),
               "opt.mu": self.opt.mu,
               "opt.count": torch.tensor(self.opt.count),
               "step": torch.tensor(self.step),
               "worker_rng": self._all_rows(torch.stack(
                   [g.get_state() for g in self.generators]))}
        if self.opt.nu is not None:
            out["opt.nu"] = self.opt.nu
        for f in SchemeState._fields:
            out[f"scheme.{f}"] = torch.as_tensor(getattr(self.scheme_state,
                                                         f))
        if self.compress_state is not None:
            out["compress.residual"] = self._all_rows(
                self.compress_state.residual)
            out["compress.step"] = torch.tensor(self.compress_state.step)
        return out

    def load_state_arrays(self, arrays: dict[str, torch.Tensor]) -> None:
        """Restore what ``state_arrays`` gave (shapes as this trainer's),
        keeping the local workers' rows of the per-worker arrays."""
        with torch.no_grad():
            self.model.flat.copy_(arrays["params"])
            self.opt.mu.copy_(arrays["opt.mu"])
            if self.opt.nu is not None:
                self.opt.nu.copy_(arrays["opt.nu"])
        self.opt = OptState(self.opt.mu, self.opt.nu,
                            int(arrays["opt.count"]))
        dev = self.model.flat.device
        self.scheme_state = SchemeState(
            levels=arrays["scheme.levels"].to(dev),
            multiplier=arrays["scheme.multiplier"].to(dev),
            num_updates=int(arrays["scheme.num_updates"]),
            entropy_bits=arrays["scheme.entropy_bits"].to(dev))
        self.step = int(arrays["step"])
        for i, w in enumerate(self.local):
            # a state must own its storage: set_state reads a row view
            # from the start of the stacked storage
            self.generators[i].set_state(arrays["worker_rng"][w].clone())
            if self.compress_state is not None:
                self.compress_state.residual[i].copy_(
                    arrays["compress.residual"][w])
        if self.compress_state is not None:
            self.compress_state = self.compress_state._replace(
                step=int(arrays["compress.step"]))

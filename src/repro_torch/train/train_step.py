"""Adaptive quantized data-parallel train step (Algorithm 1, end to end)
for M logical workers on one device.

Per step:
  1. each worker runs forward and backward on its contiguous rows of the
     global batch, and its gradient lands in its row of one (M, d)
     buffer (the model's parameters and gradients are flat views, in the
     reference's ravel order);
  2. on the update schedule: bucket statistics per worker, the merged
     mixture, and the ALQ/AMQ level update (lines 2-4);
  3. ENCODE -> gather -> DECODE -> average (lines 6-9) through
     ``dist.sync.quantized_allreduce``;
  4. one SGD-momentum / AdamW update of the flat parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core.schemes import QuantScheme
from repro_torch.dist.sync import maybe_update_levels, quantized_allreduce
from repro_torch.models.transformer import Model
from repro_torch.timing import NO_CLOCK
from .optim import OptimConfig, apply_updates, init_opt_state


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    scheme: QuantScheme = QuantScheme()
    optim: OptimConfig = OptimConfig()
    sync_mode: str = "all_gather"       # fp32 | all_gather
    update_milestones: tuple = (100, 2000)
    update_every: int = 10_000          # additionally every k steps
    workers: int = 1                    # M logical data-parallel workers


def is_update_step(tcfg: TrainConfig, step: int) -> bool:
    if step in tcfg.update_milestones:
        return True
    return tcfg.update_every > 0 and step > 0 and step % tcfg.update_every == 0


class Trainer:
    """Owns the training state of one model: the (M, d) gradient rows,
    the optimizer moments, the scheme state and the step counter.

    ``seed`` seeds the generator of the stochastic rounding on the
    model's device.
    """

    def __init__(self, model: Model, tcfg: TrainConfig, *, seed: int = 0):
        self.model = model
        self.tcfg = tcfg
        dev = model.flat.device
        self.grads = torch.zeros((tcfg.workers, model.d), device=dev)
        self.opt = init_opt_state(tcfg.optim, model.flat)
        self.scheme_state = tcfg.scheme.init_state(dev)
        self.step = 0
        self.generator = torch.Generator(device=dev).manual_seed(seed)

    def train_step(self, batch: dict[str, torch.Tensor], *,
                   u: Sequence[torch.Tensor] | None = None,
                   clock=NO_CLOCK) -> dict[str, float]:
        """One step on a global batch (ids, labels of shape (B, S)).

        ``u`` optionally gives each worker's (nb, bucket_size) uniforms
        (see ``quantized_allreduce``).  Returns the step's metrics.
        """
        tcfg, model = self.tcfg, self.model
        M = tcfg.workers
        B = batch["ids"].shape[0]
        if B % M:
            raise ValueError(f"global batch {B} does not split over {M} "
                             "workers")
        rows = B // M
        losses = []
        for w in range(M):
            g = self.grads[w]
            g.zero_()
            model.attach_grads(g)
            sl = slice(w * rows, (w + 1) * rows)
            loss = model.loss(batch["ids"][sl], batch["labels"][sl])
            loss.backward()
            losses.append(loss.detach())
        clock.mark("grad")
        self.scheme_state = maybe_update_levels(
            self.grads, tcfg.scheme, self.scheme_state,
            is_update_step(tcfg, self.step), clock=clock)
        synced, m = quantized_allreduce(
            self.grads, tcfg.scheme, self.scheme_state, mode=tcfg.sync_mode,
            u=u, generator=self.generator, clock=clock)
        grad_norm = torch.sqrt(torch.sum(synced * synced))
        self.opt = apply_updates(tcfg.optim, model.flat, synced, self.opt)
        del synced
        clock.mark("optimizer")
        self.step += 1
        return {
            "loss": torch.stack(losses).mean().item(),
            "grad_norm": grad_norm.item(),
            "comm_bits_per_coord": m.comm_bits_per_coord,
            "quant_error": m.quant_error[0].item(),
            "reduce_bits_per_coord": m.reduce_bits_per_coord,
            "broadcast_bits_per_coord": m.broadcast_bits_per_coord,
            "entropy_bits_per_coord": float(m.entropy_bits_per_coord),
        }

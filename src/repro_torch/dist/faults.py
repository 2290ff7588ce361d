"""Fault injection for the quantized collective wire.

``FaultModel`` is the declarative fault configuration shared by the
transport wrapper here and the cluster simulator (``sim.cluster``):
word-level bit corruption, whole-payload drop and delivery delay on the
wire, the delay's cost in the simulator's clock, and the per-worker
crash/rejoin Markov chain the simulator steps between rounds.

``FaultyTransport`` wraps a transport and injects faults into the
GATHERED int32 wire words, after the collective, so the real ENCODE ->
collective -> DECODE path of ``dist.sync`` runs under faults with no
change to the wire modes.  The draws come from one ``torch.Generator``
seeded from ``(model.seed, step)``: a run is reproducible, and every
receiver sees the same corruption of a sender's row (the corruption is
sender-side), in whichever process it runs: over a process group every
rank draws the same flips for all M senders and applies them to the
rows it received.  PyTorch cannot reproduce the reference's ``jax.random``
streams, so the two packages flip other bits at the same rates.

What a fault does to the step:

* a *bit flip* corrupts one bit of one word.  Without an integrity plan
  it decodes silently to a wrong gradient; with one, ``decode_checked``
  flags the bucket and ``dist.sync`` excludes it.
* a *drop* zeroes a worker's whole payload row.  An all-zero row fails
  every bucket checksum, so integrity-on sync excludes the worker exactly
  as a ``MaskedTransport`` mask does.
* a *delay* makes the payload miss the step's aggregation window: on the
  wire it acts as a drop for this step, and the simulator's cost model
  bills ``delay_ms`` to the round (``delayed_workers`` gives the same
  draw).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.packing import to_int32_bits
from .transport import StackedTransport

# domain separation of the per-step fault seed
_FOLD_STEP = 0xFA17


def _check_prob(name: str, p) -> None:
    vals = p if isinstance(p, tuple) else (p,)
    bad = [float(v) for v in vals if not 0.0 <= float(v) <= 1.0]
    if bad:
        raise ValueError(f"{name} must be in [0, 1], got {bad}")


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Declarative fault configuration (all probabilities per step).

    ``flip_prob`` is the per-WORD bit-flip probability on gathered wire
    words: a float, or a per-worker tuple to target specific workers
    (``(0.0, 0.0, 1.0, 0.0)`` corrupts only worker 2's payload).
    ``drop_prob`` / ``delay_prob`` drop or delay whole per-worker
    payloads; a delayed payload misses the step and bills ``delay_ms``
    in the simulator's cost model.  ``crash_prob`` / ``rejoin_prob``
    parameterize the per-worker up/down Markov chain that
    ``sim.cluster.step_faults`` steps: a crashed worker is absent for
    whole steps and rejoins with a stale payload.
    """

    flip_prob: float | tuple = 0.0
    drop_prob: float = 0.0
    delay_prob: float = 0.0
    delay_ms: float = 5.0
    crash_prob: float = 0.0
    rejoin_prob: float = 0.5
    seed: int = 0

    def __post_init__(self):
        for f in ("flip_prob", "drop_prob", "delay_prob", "crash_prob",
                  "rejoin_prob"):
            _check_prob(f, getattr(self, f))
        if self.delay_ms < 0:
            raise ValueError(f"delay_ms must be >= 0, got {self.delay_ms}")

    @property
    def any_wire_faults(self) -> bool:
        flips = (self.flip_prob if isinstance(self.flip_prob, tuple)
                 else (self.flip_prob,))
        return (any(float(p) > 0 for p in flips)
                or self.drop_prob > 0 or self.delay_prob > 0)

    def flip_probs(self, M: int) -> torch.Tensor:
        """(M,) per-worker word-corruption probabilities."""
        if isinstance(self.flip_prob, tuple):
            if len(self.flip_prob) != M:
                raise ValueError(
                    f"flip_prob tuple has {len(self.flip_prob)} entries "
                    f"for {M} workers")
            return torch.tensor(self.flip_prob, dtype=torch.float32)
        return torch.full((M,), float(self.flip_prob), dtype=torch.float32)

    def seed_for_step(self, step: int) -> int:
        """The seed of one step's draws: (seed, step) -> a 63-bit int."""
        ss = np.random.SeedSequence([self.seed, _FOLD_STEP, int(step)])
        return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))

    def lost_payloads(self, gen: torch.Generator, M: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """The step's first draw from its generator: (M,) bool masks of
        the dropped and the delayed payloads."""
        u = torch.rand(2, M, generator=gen, device=gen.device)
        return u[0] < self.drop_prob, u[1] < self.delay_prob

    def delayed_workers(self, step: int, M: int,
                        device="cuda") -> torch.Tensor:
        """(M,) bool: the step's delay draws, from the same generator
        state and draw as ``FaultyTransport.drop_mask``'s delay half on
        ``device``, so the simulator's cost model bills ``delay_ms`` for
        exactly the payloads the wire treated as late."""
        gen = torch.Generator(device=device).manual_seed(
            self.seed_for_step(step))
        return self.lost_payloads(gen, M)[1]


# the 32 one-bit masks as int32 bit patterns (bit 31 is negative)
_BITS = to_int32_bits(torch.tensor([1 << b for b in range(32)],
                                   dtype=torch.int64))


class FaultyTransport(StackedTransport):
    """A transport that injects wire faults into gathered payloads.

    Wraps an inner transport and corrupts the int32 rows that come out of
    ``all_gather`` / ``all_to_all``: per-word bit flips, then whole-row
    zeroing of dropped or delayed workers.  Aggregation (``weights``,
    ``active_vector``, ``mean_workers*``) is the inner transport's, so
    dropout masking composes with fault injection unchanged.

    Every draw of the step comes from one generator seeded with ``seed``
    on the device of the first payload it sees: first the drop and delay
    draws, then each collective's flip draws in call order.
    """

    def __init__(self, inner: StackedTransport, model: FaultModel,
                 seed: int):
        super().__init__(inner.size())
        self.inner = inner
        self.model = model
        self.seed = seed
        self._gen: torch.Generator | None = None
        self._drop: torch.Tensor | None = None

    # ---- delegation ------------------------------------------------------

    def local_workers(self):
        return self.inner.local_workers()

    def active_vector(self):
        return self.inner.active_vector()

    def weights(self):
        return self.inner.weights()

    def mean_workers(self, stacked):
        return self.inner.mean_workers(stacked)

    def mean_workers_bucketed(self, stacked, valid, bucket_size):
        return self.inner.mean_workers_bucketed(stacked, valid, bucket_size)

    def mean_psum(self, stacked):
        # fp32 side-band values (stats merges, fp32 mode) are not wire
        # payloads; they pass through un-faulted
        return self.inner.mean_psum(stacked)

    # ---- fault injection -------------------------------------------------

    def _generator(self, device: torch.device) -> torch.Generator:
        if self._gen is None:
            self._gen = torch.Generator(device=device).manual_seed(self.seed)
            drop, delay = self.model.lost_payloads(self._gen, self.size())
            self._drop = drop | delay
        elif self._gen.device != device:
            raise ValueError(f"fault draws live on {self._gen.device}, "
                             f"payload on {device}")
        return self._gen

    def drop_mask(self, device) -> torch.Tensor:
        """(M,) bool: workers whose payload misses this step (dropped or
        delayed).  One draw a step, shared by every payload leaf, so a
        worker loses its whole payload."""
        self._generator(torch.device(device))
        return self._drop

    def _inject(self, rows: torch.Tensor) -> torch.Tensor:
        """Corrupt (..., M, W) gathered int32 rows, axis -2 the sender;
        leading axes are receivers, who all see the same corruption."""
        if rows.dtype != torch.int32:
            return rows
        gen = self._generator(rows.device)
        M, W = rows.shape[-2:]
        u = torch.rand((M, W), generator=gen, device=rows.device)
        flip = u < self.model.flip_probs(M).to(rows.device)[:, None]
        bit = torch.randint(0, 32, (M, W), generator=gen, device=rows.device)
        mask = torch.where(flip, _BITS.to(rows.device)[bit], 0)
        rows = torch.where(self._drop[:, None], 0, rows ^ mask)
        return rows.to(torch.int32)

    def all_gather(self, per_worker):
        return self._inject(self.inner.all_gather(per_worker))

    def all_to_all(self, per_worker):
        return self._inject(self.inner.all_to_all(per_worker))


def faulty(transport: StackedTransport, model: FaultModel | None,
           step: int) -> StackedTransport:
    """Wrap ``transport`` in the model's wire faults for one step (the
    transport itself when the model is absent or injects nothing)."""
    if model is None or not model.any_wire_faults:
        return transport
    return FaultyTransport(transport, model, model.seed_for_step(step))

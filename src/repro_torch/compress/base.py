"""The compression-algorithm layer: stateful wrappers around a codec.

The codec (``core.codec``) owns how bytes are laid out in one step; a
``CompressionAlgorithm`` owns what goes into them across steps.  It wraps
one codec and an explicit ``CompressState`` that the trainer carries and
checkpoints like optimizer state.  ``dist.sync.compressed_allreduce``
sequences its hooks:

    inp = algo.prepare(flats, state)          # residual injection
    ... ENCODE -> collective -> DECODE of inp; for each local worker i:
        algo.feedback(state, i, inp[i], own)  # residual update
    new_state = algo.advance(state)

``own`` is local worker i's own lossy round trip Q(inp[i]), the decode
of the bytes it put on the wire, so error feedback costs no wire bytes.

The residuals of the L workers a process holds (all M on the stacked
transport, one a process on a process group) are the rows of one (L, d)
tensor, and both hooks work IN PLACE on it and on the (L, d) gradient
rows: at full model width every (L, d) temporary would cost as much as
the gradients.

Shipped algorithms (``repro_torch.compress.make_algorithm``):

``plain``  Stateless passthrough: the wire path is ``quantized_allreduce``
    bit for bit.
``ef``     Error feedback: ``inp_t = g_t + e_t``, ``e_{t+1} = inp_t -
    Q(inp_t)``.  A warmup gate keeps the residual at zero for the first
    ``warmup_steps`` steps, on read and on write.
``topk``   ``ef`` over the sparse payload family (``SparseCodec``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.codec import GradientCodec


class CompressState(NamedTuple):
    """The local workers' algorithm state: ``residual`` (L, d) holds
    local worker i's error-feedback memory at row i over the unpadded
    coordinates; ``step`` counts synchronizations and drives the warmup
    gate."""

    residual: torch.Tensor
    step: int

    @property
    def residual_norm(self) -> torch.Tensor:
        """(L,) norm of each local worker's residual, one row at a
        time."""
        return torch.stack([torch.linalg.vector_norm(r)
                            for r in self.residual])


@dataclasses.dataclass(frozen=True)
class CompressionAlgorithm:
    """Base algorithm; the base class is the ``plain`` passthrough."""

    codec: GradientCodec
    name: str = "plain"
    warmup_steps: int = 0

    @property
    def stateful(self) -> bool:
        return False

    @property
    def kept_fraction(self) -> float:
        """Fraction of coordinates on the wire (1.0 for dense codecs)."""
        return float(getattr(self.codec, "kept_fraction", 1.0))

    def init_state(self, workers: int, d: int, device="cuda"
                   ) -> CompressState:
        """Zero state of ``workers`` local workers' residual rows."""
        n = d if self.stateful else 0
        return CompressState(
            residual=torch.zeros((workers, n), dtype=torch.float32,
                                 device=device),
            step=0)

    def prepare(self, flats: torch.Tensor,
                state: CompressState | None) -> torch.Tensor:
        """What the codec encodes this step (residual-corrected (L, d))."""
        return flats

    def feedback(self, state: CompressState | None, i: int,
                 inp: torch.Tensor, own: torch.Tensor) -> None:
        """Update local worker i's state from its round trip ``own`` of
        ``inp``."""

    def advance(self, state: CompressState | None) -> CompressState | None:
        """The state after one synchronization."""
        if state is None:
            return None
        return state._replace(step=state.step + 1)


@dataclasses.dataclass(frozen=True)
class EFAlgorithm(CompressionAlgorithm):
    """Error feedback around any lossy codec (``name='topk'`` when the
    codec is the sparse family: the same residual, a sparser wire)."""

    name: str = "ef"

    @property
    def stateful(self) -> bool:
        return True

    def _gate(self, state: CompressState) -> bool:
        return state.step >= self.warmup_steps

    def prepare(self, flats, state):
        """Adds each worker's residual to its gradient row, in place."""
        if self._gate(state):
            flats.add_(state.residual)
        return flats

    def feedback(self, state, i, inp, own):
        # during warmup the memory stays zero: the gate applies to the
        # write too, so no error accumulates before it is used
        if self._gate(state):
            torch.sub(inp, own, out=state.residual[i])
        else:
            state.residual[i].zero_()

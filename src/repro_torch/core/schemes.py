"""Named quantization schemes: the paper's methods and its baselines.

A scheme is (initial levels, norm type, adaptivity rule); its adaptive
state is a ``SchemeState`` updated on the paper's sparse schedule.

  alq / alq_n       adaptive levels, coordinate descent   (Sec. 3.1, 3.4)
  alq_gd / alq_gd_n adaptive levels, projection-free GD   (Sec. 3.2)
  amq / amq_n       adaptive multiplier                   (Sec. 3.3)
  alq_inf / amq_inf adaptive levels under L-inf bucket normalization
  qsgdinf           uniform levels, L-inf norm            [Alistarh+ 17]
  nuqsgd            exponential p=0.5, L2 norm            [Ramezani-K.+ 19]
  trn               ternary {0,1} + sign, L-inf           [Wen+ 17]
  fp32 / super_sgd  no quantization (full-precision sync)
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from . import adapt, levels as levels_lib
from .coding import entropy_bits, level_probabilities
from .packing import NORM_DTYPES, wire_bits_for
from .quantize import NORM_L2, NORM_LINF
from .stats import TruncNormStats

ADAPTIVE_SCHEMES = ("alq", "alq_n", "alq_gd", "alq_gd_n", "amq", "amq_n",
                    "alq_inf", "amq_inf")
FIXED_SCHEMES = ("qsgdinf", "nuqsgd", "trn")
ALL_SCHEMES = ADAPTIVE_SCHEMES + FIXED_SCHEMES + ("fp32", "super_sgd")


class SchemeState(NamedTuple):
    """Adaptive-quantization state: the levels, the AMQ multiplier, the
    number of updates so far, and the achievable entropy-coded wire bits
    per coordinate of the current grid (H(L) + sign bits)."""

    levels: torch.Tensor
    multiplier: torch.Tensor
    num_updates: int
    entropy_bits: torch.Tensor


@dataclasses.dataclass(frozen=True)
class QuantScheme:
    """Static configuration of a quantization method."""

    name: str = "alq"
    bits: int = 3
    bucket_size: int = 8192
    clip_sigmas: float = 0.0          # 0 = off; TRN uses 2.5 (Eq. 49)
    max_stat_components: int = 64     # suff.-stat subsample (App. K)
    alq_sweeps: int = 10
    amq_gd_steps: int = 100
    norm_dtype: str = "float32"       # bucket norms on the wire (f32|f16)

    def __post_init__(self):
        if self.name not in ALL_SCHEMES:
            raise ValueError(f"unknown scheme {self.name!r}; known: {ALL_SCHEMES}")
        if self.norm_dtype not in NORM_DTYPES:
            raise ValueError(
                f"unknown norm_dtype {self.norm_dtype!r}; known: {NORM_DTYPES}")

    @property
    def quantized(self) -> bool:
        return self.name not in ("fp32", "super_sgd")

    @property
    def adaptive(self) -> bool:
        return self.name in ADAPTIVE_SCHEMES

    @property
    def norm_type(self) -> str:
        if self.name in ("qsgdinf", "trn") or self.name.endswith("_inf"):
            return NORM_LINF
        return NORM_L2

    @property
    def weighted_stats(self) -> bool:
        """Norm^2-weighted mixture (Sec. 3.4) vs pooled ("-N" variants)."""
        return self.adaptive and not self.name.endswith("_n")

    @property
    def _base(self) -> str:
        return self.name.replace("_inf", "")

    @property
    def num_levels(self) -> int:
        if self.name == "trn":
            return 2
        return levels_lib.num_levels(self.bits)

    def init_levels(self, device="cuda") -> torch.Tensor:
        if self.name == "trn":
            return levels_lib.ternary_levels(device=device)
        if self.name == "nuqsgd" or self._base.startswith("amq"):
            return levels_lib.exp_levels(self.bits, p=0.5, device=device)
        return levels_lib.uniform_levels(self.bits, device=device)

    @property
    def wire_bits(self) -> int:
        """Fixed-width wire bits per magnitude+sign symbol."""
        return wire_bits_for(self.num_levels)

    def init_state(self, device="cuda") -> SchemeState:
        return SchemeState(
            levels=self.init_levels(device),
            multiplier=torch.tensor(0.5, dtype=torch.float32, device=device),
            num_updates=0,
            entropy_bits=torch.tensor(float(self.wire_bits),
                                      dtype=torch.float32, device=device))

    @staticmethod
    def _entropy_bits(levels: torch.Tensor, stats: TruncNormStats
                      ) -> torch.Tensor:
        """H(L) plus one sign bit whenever the magnitude symbol is nonzero
        (App. D accounting)."""
        probs = level_probabilities(levels, stats)
        return entropy_bits(probs) + 1.0 - probs[0]

    def update_state(self, state: SchemeState, stats: TruncNormStats
                     ) -> SchemeState:
        """One level-adaptation step from fresh sufficient statistics."""
        if not self.adaptive:
            return state
        p = state.multiplier
        if self._base.startswith("amq"):
            p = adapt.amq_update(p, stats, bits=self.bits,
                                 steps=self.amq_gd_steps)
            lv = levels_lib.multiplier_to_levels(p, self.bits)
        elif self._base.startswith("alq_gd"):
            lv = adapt.alq_gd_update(state.levels, stats)
        else:
            lv = adapt.alq_update(state.levels, stats, sweeps=self.alq_sweeps)
        return SchemeState(lv, p, state.num_updates + 1,
                           self._entropy_bits(lv, stats))


def default_update_schedule(total_steps: int) -> tuple[int, ...]:
    """Paper App. K: update at 100, 2000, then every 10k iterations."""
    pts = [p for p in (100, 2000) if p < total_steps]
    pts += list(range(10_000, total_steps, 10_000))
    return tuple(pts)

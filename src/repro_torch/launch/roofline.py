"""The roofline of one rank's step on the card: the counterpart of the
reference's ``launch/hlo_analysis.py::Roofline``, with an H100's rates.

There is no compiled program to parse: ``launch.op_cost`` counts the
FLOPs, the HBM bytes and the collectives' wire bytes of the eager step.

Hardware model: an NVIDIA H100 SXM5 80GB at its 700 W power limit, from
its datasheet: 989.4e12 FLOP/s of dense bf16 tensor-core math, 3.35e12
B/s of HBM3 (the rate PERF.md's kernel bounds use) and 450e9 B/s of
NVLink in each direction a GPU (900 GB/s both ways).  A card set to a
lower power limit runs slower.  The reference's model axis of 16 spans
two 8-GPU NVLink domains, whose link between them is slower than NVLink,
so ``collective_s`` is a lower bound there.
"""
from __future__ import annotations

import dataclasses

CARD = "NVIDIA H100 SXM5 80GB, 700 W (datasheet)"
PEAK_FLOPS = 989.4e12      # dense bf16, FLOP/s
HBM_BW = 3.35e12           # HBM3, bytes/s
LINK_BW = 450e9            # NVLink, bytes/s a direction a GPU


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    hbm_bytes_per_device: float
    collective_wire_bytes: float
    bytes_by_kind: dict

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_wire_bytes / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "collective_wire_bytes": self.collective_wire_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "bytes_by_kind": dict(self.bytes_by_kind),
        }


def from_cost(cost) -> Roofline:
    """The roofline of an ``op_cost.Cost``."""
    return Roofline(flops_per_device=cost.flops,
                    hbm_bytes_per_device=cost.hbm_bytes,
                    collective_wire_bytes=cost.collective_bytes,
                    bytes_by_kind=cost.by_collective)

"""The data-parallel process group: one worker a process.

The counterpart of the reference's ``launch/mesh.py`` along its data axis
only.  ``init_process_group`` reads what ``torch.distributed.run``
(torchrun) puts in the environment, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` and ``MASTER_ADDR``/``MASTER_PORT``, or takes an explicit
``init_method`` (a ``file://`` store, as the tests use), and returns the
process's device and its ``ProcessGroupTransport``.

The backend is NCCL for a CUDA device and gloo for the CPU unless one is
named.  NCCL on the CPU is refused, and a group whose first collective
fails raises: nothing falls back to another backend.  NCCL refuses two
ranks on one card, so on a one-card machine several ranks share it
through gloo (``--device cuda:0 --backend gloo``).
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from repro_torch.dist.transport import ProcessGroupTransport

BACKENDS = ("nccl", "gloo")


def world_size() -> int:
    """The group's size torchrun announces; 0 when not started by it."""
    return int(os.environ.get("WORLD_SIZE", 0))


def init_process_group(backend: str | None = None, device="cuda", *,
                       init_method: str = "env://"
                       ) -> tuple[torch.device, ProcessGroupTransport]:
    """Join the group of ``WORLD_SIZE`` processes as ``RANK``.

    ``device`` ``cuda`` means ``cuda:LOCAL_RANK``.  Returns (this
    process's device, the group's transport).  A CUDA device must exist;
    the group's first collective runs here, so a group that cannot form
    raises now rather than mid-step.
    """
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; known: {BACKENDS}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the NCCL backend moves CUDA tensors only, not "
                         f"{device.type} ones: use --backend gloo on the "
                         "CPU")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA device for {device}")
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    probe = torch.ones(1, device=device)
    dist.all_reduce(probe)
    if int(probe.item()) != dist.get_world_size():
        raise RuntimeError(f"the {backend} group summed {probe.item()} "
                           f"over {dist.get_world_size()} ranks")
    return device, ProcessGroupTransport()

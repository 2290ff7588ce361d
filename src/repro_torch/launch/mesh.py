"""The process groups: one data-parallel worker a process, and with
tensor parallelism a (data x model) grid of them.

The counterpart of the reference's ``launch/mesh.py``.  ``init_process_group`` reads what ``torch.distributed.run``
(torchrun) puts in the environment, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` and ``MASTER_ADDR``/``MASTER_PORT``, or takes an explicit
``init_method`` (a ``file://`` store, as the tests use), and returns the
process's device and its ``ProcessGroupTransport``.

The backend is NCCL for a CUDA device and gloo for the CPU unless one is
named.  NCCL on the CPU is refused, and a group whose first collective
fails raises: nothing falls back to another backend.  NCCL refuses two
ranks on one card, so on a one-card machine several ranks share it
through gloo (``--device cuda:0 --backend gloo``).

``init_grid`` lays the world out as the reference's ``make_local_mesh``
lays its devices out on ``jax.make_mesh((dp, tp), ("data", "model"))``:
rank r is at (data r // tp, model r % tp).  It returns the model group
(a ``TPCtx`` for the model's collectives), a transport over the data
group (for the quantized wire) and a ``TPCtx`` over the data group too
(serving's caches split the batch, or a long context, over it), the
counterparts of the reference's ``mesh_axes``.

``make_production_mesh`` and ``mesh_axes`` give the reference's two
production layouts, (16, 16) over ("data", "model") and (2, 16, 16) over
("pod", "data", "model"), as shapes only.  ``fake_grid`` makes one rank
of such a layout, on the ``meta`` device under torch's ``"fake"``
process-group backend, whose collectives move nothing: the dry run
(``launch.dryrun``) runs the rank's step there without a cluster.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
from typing import Iterator, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.dist.transport import ProcessGroupTransport
from repro_torch.models import layers
from repro_torch.models.layers import TPCtx

BACKENDS = ("nccl", "gloo")


def world_size() -> int:
    """The group's size torchrun announces; 0 when not started by it."""
    return int(os.environ.get("WORLD_SIZE", 0))


def refuse_group_flags(backend: str | None, tp: int) -> None:
    """A launcher's check when torchrun did not start it: ``--backend``
    and ``--tp`` > 1 need a process group."""
    for flag, given in (("--backend", backend), ("--tp", tp > 1)):
        if given:
            raise ValueError(f"{flag} needs a process group: start the "
                             "launcher with torch.distributed.run")


def init_process_group(backend: str | None = None, device="cuda", *,
                       init_method: str = "env://"
                       ) -> tuple[torch.device, ProcessGroupTransport]:
    """Join the group of ``WORLD_SIZE`` processes as ``RANK``.

    ``device`` ``cuda`` means ``cuda:LOCAL_RANK``.  Returns (this
    process's device, the group's transport).  A CUDA device must exist;
    the group's first collective runs here, so a group that cannot form
    raises now rather than mid-step.  A process that is in the world
    already (a script that drives several launches in one process) keeps
    its group, which must be of ``backend``.
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
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method,
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    elif dist.get_backend() != backend:
        raise ValueError(f"this process is in a {dist.get_backend()} "
                         f"group, not a {backend} one")
    probe = torch.ones(1, device=device)
    dist.all_reduce(probe)
    if int(probe.item()) != dist.get_world_size():
        raise RuntimeError(f"the {backend} group summed {probe.item()} "
                           f"over {dist.get_world_size()} ranks")
    return device, ProcessGroupTransport()


class Grid(NamedTuple):
    device: torch.device
    transport: ProcessGroupTransport   # over this rank's data group
    tp_ctx: TPCtx                      # over this rank's model group
    dp: int
    data_ctx: TPCtx                    # over this rank's data group


def _grid_groups(world: int, tp: int, rank: int):
    """Every model group and every data group of a world of dp * tp ranks
    in ``init_grid``'s order (rank r at (r // tp, r % tp)), each made by
    every rank as ``new_group`` requires; returns rank's two."""
    dp = world // tp
    model_group = data_group = None
    for d in range(dp):
        g = dist.new_group([d * tp + m for m in range(tp)])
        if d == rank // tp:
            model_group = g
    for m in range(tp):
        g = dist.new_group([d * tp + m for d in range(dp)])
        if m == rank % tp:
            data_group = g
    return model_group, data_group


def _probe(group, device, size: int, what: str) -> None:
    probe = torch.ones(1, device=device)
    dist.all_reduce(probe, group=group)
    if int(probe.item()) != size:
        raise RuntimeError(f"the {what} group summed {probe.item()} over "
                           f"{size} ranks")


def init_grid(tp: int, backend: str | None = None, device="cuda", *,
              init_method: str = "env://") -> Grid:
    """Join the world of ``WORLD_SIZE`` = dp * tp processes as ``RANK``
    and form its groups: tp = min(tp, world), which must divide the
    world; rank r is data rank r // tp and model rank r % tp.  Every rank
    creates every model group and every data group, in the same order,
    as ``torch.distributed.new_group`` requires; each group's first
    collective runs here, so a group that cannot form raises now."""
    world = int(os.environ["WORLD_SIZE"])
    tp = min(tp, world)
    if tp < 1 or world % tp:
        raise ValueError(f"tp={tp} does not divide the world of {world} "
                         "ranks")
    dp = world // tp
    device, _ = init_process_group(backend, device, init_method=init_method)
    model_group, data_group = _grid_groups(world, tp, dist.get_rank())
    _probe(model_group, device, tp, "model")
    _probe(data_group, device, dp, "data")
    return Grid(device, ProcessGroupTransport(data_group),
                TPCtx.over(model_group), dp, TPCtx.over(data_group))


# ---- the production layouts (shapes only) ---------------------------------


@dataclasses.dataclass(frozen=True)
class Layout:
    """A production layout: the extent of each named axis (the reference's
    ``Mesh.shape``), the data axes first and "model" last."""

    shape: dict

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def make_production_mesh(*, multi_pod: bool = False) -> Layout:
    """The reference's production layout: 16 x 16 a pod over ("data",
    "model"), and 2 pods over ("pod", "data", "model")."""
    if multi_pod:
        return Layout({"pod": 2, "data": 16, "model": 16})
    return Layout({"data": 16, "model": 16})


def mesh_axes(mesh) -> tuple[tuple[str, ...], str]:
    """(data_axes, model_axis) of a layout built above."""
    data_axes = tuple(n for n in mesh.axis_names if n in ("pod", "data"))
    return data_axes, "model"


@contextlib.contextmanager
def fake_grid(mesh, rank: int = 0) -> Iterator[Grid]:
    """One rank (``rank``, 0 by default) of ``mesh`` on the meta device:
    a ``"fake"`` process group of the layout's world size, its model and
    data groups made as ``init_grid`` makes them (the data group spans
    every data axis, pod and data), yielded as a ``Grid``.  Every
    collective on it completes at once and moves nothing.  On exit every
    group it made is destroyed and the model groups' names are
    forgotten: nothing stays set up.  A process already in a group
    cannot make one."""
    # torch's fake backend lives in its testing package: imported here
    # alone, where it registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_grid: this process is in a process group "
                           "already")
    world = mesh.size
    tp = mesh.shape[mesh_axes(mesh)[1]]
    with layers.group_scope():
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world)
        try:
            model_group, data_group = _grid_groups(world, tp, rank)
            yield Grid(torch.device("meta"),
                       ProcessGroupTransport(data_group),
                       TPCtx.over(model_group), world // tp,
                       TPCtx.over(data_group))
        finally:
            dist.destroy_process_group()

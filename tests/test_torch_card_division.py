"""Where the reference divides, the port rounds alike on the CPU and on the
card, and as the reference does (checks on the CPU; ``test_torch_cuda.py``
runs the same routes on the card against the CPU).

The reference divides by numbers it knows when it traces: M workers in its
transports' ``mean(0)``, ``psum / M`` and ``psum_scatter / M``, in FSDP's
decode-then-mean of each round and the ``final_norm`` mean, and the
micro-batch count k.  XLA compiles each into the sum in worker order times
the float32 reciprocal.  AdamW divides by its bias corrections, which come
from the traced step, and XLA leaves that a division.  ATen differs by
device: its CPU ``mean(0)`` divides, its CUDA ``mean(0)`` multiplies after
adding in an order of its own, and its CUDA division by a Python number,
or by a 0-dim CPU tensor, multiplies by the rounded reciprocal.

So every route runs, at M = 3 and 5, under ``DivisionAudit``, a
``TorchDispatchMode`` that rejects two kinds of ATen call made by the
route's own code: ``repro_torch`` outside ``models/`` and ``core/stats.py``
(the models' means and the truncated normals of the level fit, which go
through ``exp`` and ``erf``, are held at a tolerance: the two devices'
libraries round those differently), and not the backward that a
``.backward()`` line runs.

- a division by a Python number that is not a power of two, or by a tensor
  on another device than the dividend;
- a ``mean`` or ``sum`` over the worker axis: of a floating tensor whose
  leading axis holds the M workers.

The routes run on the meta device, where a 0-dim CPU divisor shows as a
tensor on another device; the simulator's step, which reads its metrics
on the host, runs on the CPU.  Where the reference has the function, the
port's CPU result equals it bit for bit at M = 3 and 5: ``mean_workers``,
``mean_psum`` and FSDP's float32 ``psum_scatter / M``, jitted as the
reference runs them, and AdamW over three steps, op by op (a jitted update
fuses its products and adds).
"""
import functools
import linecache
import math
import os
import sys

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro_torch
from repro.dist import transport as jtransport
from repro.train import optim as jopt
from repro_torch import configs, numerics
from repro_torch.compress import SparseCodec
from repro_torch.core.codec import make_codec
from repro_torch.core.schemes import QuantScheme
from repro_torch.dist import fsdp, sync
from repro_torch.dist.fsdp import SeedKey
from repro_torch.dist.transport import StackedTransport
from repro_torch.launch.mesh import Layout, fake_grid
from repro_torch.models.transformer import Model
from repro_torch.sim import ClusterConfig, Scenario, run_scenario
from repro_torch.train import optim
from repro_torch.train.train_step import TrainConfig, Trainer

# one thread: xdist workers that each take every core starve one another
torch.set_num_threads(1)

SRC = os.path.dirname(os.path.abspath(repro_torch.__file__)) + os.sep
OUT_OF_SCOPE = ("models" + os.sep, os.path.join("core", "stats.py"))
BS = 256
aten = torch.ops.aten


@functools.lru_cache(maxsize=None)
def _abspath(path: str) -> str:
    """A frame's file as ``SRC`` spells it (a ``sys.path`` entry may
    hold ``..``)."""
    return os.path.abspath(path)


def _site() -> str | None:
    """``file:line`` of the innermost frame of ``repro_torch`` that called
    the op, or None where that frame is in ``OUT_OF_SCOPE`` or runs a
    ``.backward()`` (the engine's ops of the model's backward) or there is
    none."""
    f = sys._getframe(2)
    while f is not None:
        path = _abspath(f.f_code.co_filename)
        if path.startswith(SRC):
            rel = path[len(SRC):]
            if rel.startswith(OUT_OF_SCOPE):
                return None
            if ".backward(" in linecache.getline(path, f.f_lineno):
                return None
            return f"{rel}:{f.f_lineno}"
        f = f.f_back
    return None


def _power_of_two(c) -> bool:
    m, _ = math.frexp(abs(float(c)))
    return m == 0.5


def _fault(func, args, kwargs, M) -> str | None:
    """Why an ATen call would round otherwise on the card, or None."""
    packet = func.overloadpacket
    if (packet in (aten.div, aten.div_) and isinstance(args[0], torch.Tensor)
            and kwargs.get("rounding_mode") is None):
        x, c = args[0], args[1]
        if isinstance(c, (int, float)) and not _power_of_two(c):
            return f"{func} divides by the Python number {c}"
        if isinstance(c, torch.Tensor) and c.device != x.device:
            return (f"{func} divides a {x.device.type} tensor by one on "
                    f"{c.device.type}")
    if packet in (aten.mean, aten.sum):
        x = args[0]
        if x.is_floating_point() and x.dim() and x.shape[0] == M:
            dims = args[1] if len(args) > 1 else kwargs.get("dim")
            if not dims or 0 in [d % x.dim() for d in dims]:
                return (f"{func} reduces the worker axis of a "
                        f"{tuple(x.shape)} tensor")
    return None


class DivisionAudit(TorchDispatchMode):
    """Records, as ``faults``, every call of the routes' own code that
    would round otherwise on the card than on the CPU."""

    def __init__(self, M: int):
        super().__init__()
        self.M, self.faults = M, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        why = _fault(func, args, kwargs, self.M)
        if why is not None:
            site = _site()
            if site is not None:
                self.faults.append(f"{site}: {why}")
        return func(*args, **kwargs)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_the_audit_flags_what_rounds_otherwise_on_the_card():
    """The audit itself: what it flags and what it lets through, called
    from ``repro_torch`` code (``numerics``) and from a test (not seen)."""
    M = 3
    x = _meta(M, 8)
    exec_in_port = {"__file__": SRC + "audit_probe.py"}
    code = compile("\n".join([
        "a = x / 3", "b = x.mean(0)", "c = x / torch.tensor(3.0)",
        "d = x.sum(0)", "e = x * 0.5", "f = x / 4", "g = x.mean(1)"]),
        SRC + "audit_probe.py", "exec")
    with DivisionAudit(M) as audit:
        exec(code, dict(exec_in_port, x=x, torch=torch))
        numerics.worker_mean(x)
        numerics.divide(x, 3.0)
        x / 3                                  # the test's own: not seen
    assert [f.split(": ")[0] for f in audit.faults] == [
        f"audit_probe.py:{i}" for i in (1, 2, 3, 4)], audit.faults


def _stacked(M, name):
    t = StackedTransport(M)
    if name == "reduce_scatter_mean":
        return t.reduce_scatter_mean(_meta(M, M * 16))
    return getattr(t, name)(_meta(M, 64))


def _group(M, name):
    with fake_grid(Layout({"data": M, "model": 1})) as grid:
        if name == "reduce_scatter_mean":
            return grid.transport.reduce_scatter_mean(_meta(1, M * 16))
        return grid.transport.mean_psum(_meta(1, 64))


def _fsdp(M, quantized):
    scheme = QuantScheme(name="alq", bits=3, bucket_size=BS)
    _, nb = fsdp.chunk_plan(7 * M * BS, BS, M)
    return fsdp.reduce_scatter(
        _meta(M, nb * BS), scheme.init_levels("meta"), [SeedKey(0)] * M,
        transport=StackedTransport(M), codec=make_codec(scheme, "uniform"),
        quantized=quantized)


def _allreduce(M, kind):
    scheme = QuantScheme(name="alq", bits=3, bucket_size=BS)
    codec = (SparseCodec(bucket_size=BS, num_levels=scheme.num_levels, k=8)
             if kind == "topk" else None)
    rows = _meta(M, 2000)
    u = ([_meta(*codec.rounding_shape(codec.plan(2000).nb))] * M
         if kind == "topk" else None)
    return sync.quantized_allreduce(
        rows, scheme, scheme.init_state("meta"),
        mode="fp32" if kind == "fp32" else "all_gather", codec=codec, u=u)


def _adamw(M):
    del M
    cfg = optim.OptimConfig(name="adamw", lr=1e-2, weight_decay=1e-2)
    flat = _meta(1000)
    state = optim.init_opt_state(cfg, flat)
    for _ in range(3):
        state = optim.apply_updates(cfg, flat, _meta(1000), state)
    return state


def _trainer(M, param_mode):
    """Rank 0 of M data ranks on the meta device: one step of qwen3-0.6b's
    SMOKE config in 3 micro-batches."""
    cfg = configs.get_smoke_config("qwen3-0.6b")
    scheme = QuantScheme(name="alq", bits=3, bucket_size=BS)
    with fake_grid(Layout({"data": M, "model": 1})) as grid:
        model = Model(cfg, device=grid.device, param_mode=param_mode,
                      dp=grid.dp, transport=grid.transport,
                      fsdp_scheme=scheme, tp_ctx=grid.tp_ctx,
                      data_ctx=grid.data_ctx)
        trainer = Trainer(model, TrainConfig(
            scheme=scheme, optim=optim.OptimConfig(name="adamw"),
            workers=M, microbatches=3, update_milestones=()),
            transport=grid.transport)
        ids = _meta(3 * M, 16, dtype=torch.int32)
        return trainer.step_tensors({"ids": ids, "labels": ids})


def _simulator(M):
    scn = Scenario(name="division", schemes=("alq",),
                   topologies=("allreduce",), steps=1, seq_len=16,
                   batch_per_worker=1, update_milestones=(),
                   cluster=ClusterConfig(num_workers=M))
    return run_scenario(scn, device="cpu")


ROUTES = {
    "stacked mean_workers": lambda M: _stacked(M, "mean_workers"),
    "stacked mean_psum": lambda M: _stacked(M, "mean_psum"),
    "stacked reduce_scatter_mean": lambda M: _stacked(M,
                                                      "reduce_scatter_mean"),
    "group reduce_scatter_mean": lambda M: _group(M, "reduce_scatter_mean"),
    "group mean_psum": lambda M: _group(M, "mean_psum"),
    "fsdp quantized reduce-scatter": lambda M: _fsdp(M, True),
    "fsdp float32 reduce-scatter": lambda M: _fsdp(M, False),
    "fp32 sync": lambda M: _allreduce(M, "fp32"),
    "topk sync": lambda M: _allreduce(M, "topk"),
    "adamw": _adamw,
    "micro-batch mean, dp": lambda M: _trainer(M, "dp"),
    "micro-batch mean, fsdp": lambda M: _trainer(M, "fsdp"),
    "simulator's exact mean": _simulator,
}


@pytest.mark.parametrize("M", [3, 5])
@pytest.mark.parametrize("route", list(ROUTES))
def test_route_rounds_alike_on_the_cpu_and_the_card(route, M):
    with DivisionAudit(M) as audit:
        ROUTES[route](M)
    assert not audit.faults, "\n".join(audit.faults)


# ---- against the live reference, on the CPU --------------------------------

def _rows(shape, seed):
    """Normal values at scales e^(3 z) a row: sums whose roundings the
    order and the division move."""
    rng = np.random.default_rng(seed)
    scale = np.exp(3.0 * rng.standard_normal((shape[0],) + (1,) *
                                             (len(shape) - 1)))
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _reference_means(M):
    """The reference's three means over M workers, jitted."""
    mesh = jtransport.MeshTransport(("data",))
    return {
        "mean_workers": jax.jit(jtransport.MeshTransport(()).mean_workers),
        "mean_psum": jax.jit(jax.vmap(mesh.mean_psum, axis_name="data")),
        "reduce_scatter_mean": jax.jit(jax.vmap(
            lambda g: jax.lax.psum_scatter(g, "data", scatter_dimension=0,
                                           tiled=True) / M,
            axis_name="data")),
    }


@pytest.mark.parametrize("M", [3, 5])
def test_worker_means_equal_the_reference_bit_for_bit(M):
    ref = _reference_means(M)
    t = StackedTransport(M)
    x = _rows((M, 4096), seed=M)
    got = t.mean_workers(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), np.asarray(
        ref["mean_workers"](x)).view(np.int32))
    got = t.mean_psum(torch.from_numpy(x)).numpy()
    want = np.asarray(ref["mean_psum"](x))
    for w in range(M):      # every worker holds the same mean
        np.testing.assert_array_equal(got.view(np.int32),
                                      want[w].view(np.int32))
    rows = _rows((M, M * 1024), seed=10 + M)
    got = t.reduce_scatter_mean(torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), np.asarray(
        ref["reduce_scatter_mean"](rows)).view(np.int32))


@pytest.mark.parametrize("schedule", [
    {}, {"warmup_steps": 2, "decay_milestones": (2,)}])
def test_adamw_equals_the_reference_bit_for_bit(schedule):
    """Three AdamW steps from the same state, op by op as the reference's
    eager update: parameters and both moments bit-equal at every step."""
    kw = dict(name="adamw", lr=0.05, weight_decay=1e-2, **schedule)
    jcfg, cfg = jopt.OptimConfig(**kw), optim.OptimConfig(**kw)
    rng = np.random.default_rng(7)
    p0 = rng.standard_normal(20_000).astype(np.float32)
    jp = {"w": jax.numpy.asarray(p0)}
    jstate = jopt.init_opt_state(jcfg, jp)
    flat = torch.from_numpy(p0.copy())
    state = optim.init_opt_state(cfg, flat)
    for _ in range(3):
        g = (rng.standard_normal(20_000)
             * np.exp(rng.standard_normal(20_000))).astype(np.float32)
        with jax.disable_jit():
            jp, jstate = jopt.apply_updates(
                jcfg, jp, {"w": jax.numpy.asarray(g)}, jstate)
        state = optim.apply_updates(cfg, flat, torch.from_numpy(g), state)
        for got, want in ((flat, jp["w"]), (state.mu, jstate.mu["w"]),
                          (state.nu, jstate.nu["w"])):
            np.testing.assert_array_equal(
                got.numpy().view(np.int32),
                np.asarray(want).view(np.int32))


def test_sqrt_is_correctly_rounded():
    """``numerics.sqrt`` on the CPU against numpy's (IEEE) square root."""
    v = np.abs(_rows((1, 100_000), seed=3)[0])
    got = numerics.sqrt(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  np.sqrt(v).view(np.int32))

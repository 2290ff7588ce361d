"""The dry run (``repro_torch.launch.dryrun``) against the reference's.

``op_cost`` is held to the three cases the reference pins for its
``jaxpr_cost`` (``tests/test_substrate.py``): a matmul's FLOPs and bytes,
a loop's iterations, a collective inside a loop over a fake group; its
``peak_bytes`` to the hand count of a toy forward and backward.
``ModelConfig``'s parameter counts equal the reference's as integers, for
every config and SMOKE config.

One reference child (``tests/torch_dryrun_reference.py``, 8 host CPU
devices) gives ``auto_microbatches`` and ``build_model``'s decisions for
every arch x input shape x production layout, with the reference's
budgets, and walks the jaxpr of the reference's dry-run function, as
``lower_pair`` builds it without compiling it, for five cases on the
2 x 2 x 2 (pod, data, model) layout of ``tests/test_distributed.py``:
SMOKE llama3.2-1b's train step at ``InputShape("t", 64, 8, "train")``,
a prefill and a ``("d", 128, 8, "decode")`` step, and the train step of
the MoE (mixtral) and RWKV6 SMOKE configs.  The port runs rank 0 of the
same layout on the meta device.  Held equal: the matmul FLOPs, the
collective wire bytes, the model FLOPs a device and the state bytes a
device.  Two standing differences (ROADMAP §3) are held at their
values: a train step's metrics move 24 wire bytes more in the port (it
all-gathers its 4 workers' losses and quantization errors, 32 bytes,
where the reference's psum of one loss moves 8), and RWKV6's chunk
recurrence counts 44,302,336 matmul FLOPs in the port against the
reference's 59,244,544 (the big projections are equal), a ratio of
866,385,920 / 881,328,128 of the step's.  The reference's attention is
a blockwise loop, which the port's dry run would count as the card's
kernels (``test_torch_attention_kernel.py``); here the port's attention
runs the same loop, its plain ``_flash``, so that the counts compare
the same work.
"""
import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from repro import configs as jconfigs
from repro_torch import configs
from repro_torch.configs.shapes import SHAPES, InputShape
from repro_torch.launch import dryrun, op_cost
from repro_torch.launch.mesh import (
    Layout, fake_grid, make_production_mesh, mesh_axes)
from repro_torch.models import attention

# one thread: xdist workers that each take every core starve one another
torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
DEADLINE_S = 300
# the reference's FSDP_BYTES_THRESHOLD and ACTIVATION_BUDGET
REF_FSDP_BYTES, REF_ACTIVATIONS = 6e9, 8e9
LAYOUT_222 = Layout({"pod": 2, "data": 2, "model": 2})
CASES = [
    ("llama3.2-1b", ("t", 64, 8, "train")),
    ("llama3.2-1b", ("p", 64, 8, "prefill")),
    ("llama3.2-1b", ("d", 128, 8, "decode")),
    ("mixtral-8x7b", ("t", 64, 8, "train")),
    ("rwkv6-7b", ("t", 64, 8, "train")),
]
# the standing differences: the train step's metrics on the wire, and
# RWKV6's chunk recurrence (exact matmul FLOPs, port and reference)
METRIC_WIRE_BYTES = 24
RWKV_MATMUL = (866_385_920, 881_328_128)


class _Reference:
    """The reference child, started once and read when first needed."""

    def __init__(self, out):
        self.out = out
        env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
                   PYTHONPATH=os.path.join(ROOT, "src"))
        env.pop("XLA_FLAGS", None)
        cases = [{"arch": a, "shape": list(s)} for a, s in CASES]
        self.child = subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests",
                                          "torch_dryrun_reference.py"),
             str(out), json.dumps(cases)],
            env=env, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)
        self._result = None

    def result(self) -> dict:
        if self._result is None:
            _, err = self.child.communicate(timeout=DEADLINE_S)
            assert self.child.returncode == 0, err[-4000:]
            with open(self.out) as f:
                self._result = json.load(f)
        return self._result


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    ref = _Reference(tmp_path_factory.mktemp("dryrun") / "ref.json")
    yield ref
    if ref.child.poll() is None:
        ref.child.kill()
        ref.child.communicate()


# ---- op_cost: the reference's three cases, and the live bytes ------------


def test_op_cost_counts_a_matmuls_flops_and_bytes(reference):
    a = torch.empty(64, 128, device="meta")
    b = torch.empty(128, 32, device="meta")
    c = op_cost.analyze_fn(lambda a, b: a @ b, a, b)
    assert c.flops == c.matmul_flops == 2 * 64 * 128 * 32
    # bytes: operands + result
    assert c.hbm_bytes == (64 * 128 + 128 * 32 + 64 * 32) * 4


def test_op_cost_counts_every_iteration_of_a_loop():
    def f(x, ws):
        for w in ws:
            x = x @ w
        return x

    x = torch.empty(16, 16, device="meta")
    ws = torch.empty(10, 16, 16, device="meta")
    assert op_cost.analyze_fn(f, x, ws).flops == 10 * 2 * 16 * 16 * 16


def test_op_cost_counts_collectives_inside_a_loop():
    def f(xs, group):
        c = torch.zeros(8, device="meta")
        for x in xs:
            x = x.clone()
            dist.all_reduce(x, group=group)
            c = c + x
        return c

    with fake_grid(Layout({"data": 1, "model": 8})) as grid:
        c = op_cost.analyze_fn(f, torch.empty(5, 8, device="meta"),
                               grid.tp_ctx.process_group)
    # 5 iterations x 8 floats x 4 bytes x weight 2.0
    assert c.collective_bytes == 5 * 8 * 4 * 2.0
    assert c.by_collective == {"all_reduce": 5 * 8 * 4 * 2.0}


def test_peak_bytes_of_a_forward_and_backward_is_the_hand_count():
    MiB = 2 ** 20
    x = torch.empty(1024, 1024, device="meta")                 # 4 MiB
    w1 = torch.empty(1024, 4096, device="meta", requires_grad=True)
    w2 = torch.empty(4096, 1024, device="meta", requires_grad=True)

    def step(x, w1, w2):
        h = torch.relu(x @ w1)          # x @ w1 dies; relu's h is saved
        (h @ w2).sum().backward()

    c = op_cost.analyze_fn(step, x, w1, w2)
    # the arguments (36 MiB) stay live.  The peak comes in relu's
    # backward: h, h's gradient (g @ w2^T), w2's gradient and relu's
    # input gradient, 16 MiB each, beside the loss and its seed (4 bytes
    # each); the (1024, 1024) product died with the sum.
    assert c.peak_bytes == 36 * MiB + 4 * 16 * MiB + 2 * 4


def test_an_operator_with_its_own_kernel_is_counted_whole():
    """``silu_backward`` has a kernel of its own (one launch, one output
    on the card) beside its CompositeImplicit decomposition, so it is
    neither decomposed into its intermediates nor charged their FLOPs."""
    MiB = 2 ** 20
    x = torch.empty(1024, 1024, device="meta")                 # 4 MiB
    w1 = torch.empty(1024, 4096, device="meta", requires_grad=True)
    w2 = torch.empty(4096, 1024, device="meta", requires_grad=True)

    def step(x, w1, w2):
        h = torch.nn.functional.silu(x @ w1)    # silu saves x @ w1
        (h @ w2).sum().backward()

    c = op_cost.analyze_fn(step, x, w1, w2)
    # the peak comes in silu's backward: x @ w1 (saved), h (step's
    # local), h's and w2's gradients and silu's input gradient, 16 MiB
    # each, beside the loss and its seed; none of the decomposition's
    # intermediates (sigmoid, 1 - sigmoid, ...)
    assert c.peak_bytes == 36 * MiB + 5 * 16 * MiB + 2 * 4
    n = 1024 * 4096
    # silu and silu_backward one FLOP an element each, and the sum one
    # an input element (its backward is an expand, a view)
    assert c.flops - c.matmul_flops == 2 * n + 1024 * 1024


# ---- the configs' parameter counts ------------------------------------


@pytest.mark.parametrize("arch", [*configs.ARCH_NAMES, "paper-proxy"])
def test_parameter_counts_equal_the_references(arch):
    for port, ref in ((configs.get_config(arch), jconfigs.get_config(arch)),
                      (configs.get_smoke_config(arch),
                       jconfigs.get_smoke_config(arch))):
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()
        assert port.sub_quadratic == ref.sub_quadratic
        assert isinstance(port.param_count(), int)


# ---- the layouts and their decisions ----------------------------------


def test_fake_grid_makes_one_rank_of_the_layout_and_tears_down():
    mesh = make_production_mesh(multi_pod=True)
    assert (mesh.axis_names, mesh.size) == (("pod", "data", "model"), 512)
    assert mesh_axes(mesh) == (("pod", "data"), "model")
    with fake_grid(mesh, rank=37) as grid:
        assert dist.get_backend() == "fake"
        assert dist.get_world_size() == 512
        # rank r is data rank r // 16 and model rank r % 16; the data
        # group spans pod and data
        assert (grid.tp_ctx.tp, grid.tp_ctx.rank) == (16, 5)
        assert (grid.dp, grid.data_ctx.rank) == (32, 2)
        assert grid.transport.local_workers() == [2]
        with pytest.raises(RuntimeError, match="in a process group"):
            with fake_grid(mesh):
                pass
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        with fake_grid(mesh):
            raise ValueError("inside")
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_layout_decisions_equal_the_references(reference, arch):
    ref = [r for r in reference.result()["plans"] if r["arch"] == arch]
    assert len(ref) == len(SHAPES) * 2
    for r in ref:
        cfg, shape = configs.get_config(arch), SHAPES[r["shape"]]
        mesh = make_production_mesh(multi_pod=r["mesh"] == "multi")
        p = dryrun.plan(cfg, mesh, shape, fsdp_threshold=REF_FSDP_BYTES)
        got = {"microbatches": dryrun.auto_microbatches(
            cfg, shape, mesh, budget=REF_ACTIVATIONS),
            "tp": p["tp"], "dp": p["dp"],
            "data_axes": list(p["data_axes"]),
            "seq_axes": list(p["seq_axes"]),
            "batch_axes": list(p["batch_axes"]),
            "param_mode": p["param_mode"], "fsdp_sync": p["fsdp_sync"]}
        assert got == {k: r[k] for k in got}, (r["shape"], r["mesh"])


# ---- the dry run against the reference's on 2 x 2 x 2 -------------------


def _plain_attention(q, k, v, heads, window=0):
    """The reference's blockwise loop in the kernels' place."""
    return attention._flash(q, attention._take_heads(k, heads),
                            attention._take_heads(v, heads), causal=True,
                            window=window)


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{a}-{s[3]}" for a, s in CASES])
def test_dry_run_counts_equal_the_references(reference, i, monkeypatch):
    arch, shape = CASES[i]
    shape = InputShape(*shape)
    cfg = configs.get_smoke_config(arch)
    monkeypatch.setattr(attention, "attention_kernel", _plain_attention)
    cost, info = dryrun.dry_pair(cfg, shape, LAYOUT_222)
    assert not dist.is_initialized()
    ref = reference.result()["costs"][i]
    if arch == "rwkv6-7b":
        assert (cost.matmul_flops, ref["matmul_flops"]) == RWKV_MATMUL
    else:
        assert cost.matmul_flops == ref["matmul_flops"]
    extra = METRIC_WIRE_BYTES if shape.kind == "train" else 0
    assert cost.collective_bytes == ref["collective_bytes"] + extra
    assert (dryrun.model_flops_per_device(cfg, shape, LAYOUT_222)
            == ref["model_flops"])
    if shape.kind == "train":
        assert info["state_bytes"] == ref["state_bytes"]
    mem = info["bytes_per_device"]
    assert mem["total"] == mem["argument"] + mem["temp"] == cost.peak_bytes
    assert 0 < cost.matmul_flops < cost.flops


def test_a_train_step_runs_each_kernel_as_one_operator():
    seen = {}
    run = op_cost.CostMode.__torch_dispatch__

    def spy(self, func, types, args=(), kwargs=None):
        out = run(self, func, types, args, kwargs)
        if func.namespace == "repro_torch":
            seen.setdefault(func.overloadpacket.__name__, (args, out))
        return out

    op_cost.CostMode.__torch_dispatch__ = spy
    try:
        dryrun.dry_pair(configs.get_smoke_config("llama3.2-1b"),
                        InputShape("t", 16, 8, "train"), LAYOUT_222)
    finally:
        op_cost.CostMode.__torch_dispatch__ = run
    # an update step: the level fit's statistics run too
    assert {"quantize", "dequantize", "bucket_stats",
            "tp_all_reduce"} <= set(seen)
    args, (codes, norms) = seen["quantize"]
    nb, bs = args[0].shape
    assert (codes.dtype, codes.shape, norms.shape) == (torch.int8,
                                                       (nb, bs), (nb,))


def test_cli_writes_records_that_make_tables_renders(tmp_path, capsys):
    out = tmp_path / "records"
    assert dryrun.main(["--arch", "paper-proxy", "--shape",
                        "decode_32k,long_500k", "--mesh", "both",
                        "--out", str(out)]) == 0
    assert not dist.is_initialized()
    recs = [json.loads(p.read_text()) for p in sorted(out.iterdir())]
    assert len(recs) == 4 and all(r["ok"] for r in recs)
    for r in recs:
        assert {"microbatches", "bytes_per_device", "roofline",
                "model_flops_per_device", "useful_flops_ratio",
                "run_s"} <= set(r)
        assert r["roofline"]["dominant"] in ("compute", "memory",
                                             "collective")
    spec = importlib.util.spec_from_file_location(
        "make_tables", os.path.join(ROOT, "experiments", "make_tables.py"))
    tables = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tables)
    table = tables.fmt(recs).splitlines()
    assert len(table) == 2 + 4 and all("| ok |" in row for row in table[2:])

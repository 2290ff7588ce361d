"""The span recorder (``repro_torch.timing``) and what the train step
records with it.

On the CPU: spans nest, with parents, inherited workers, counters on the
innermost span and self time; ``NO_CLOCK`` records nothing, installs no
hook and creates no CUDA event; a toy trainer handed a ``StageClock``
records each worker's ``forward``, ``backward`` and, under remat
``"full"``, ``recompute``, and the wire's spans of ``all_gather``,
``two_phase`` with integrity words and ``fp32``, keeps the stage marks
it had (fp32's mean is now the ``collective`` stage), counts the bytes
the plan reckons on the wire, and leaves no hook behind; a model group's
all-reduce is a ``tp_all_reduce`` span with its bytes; the launcher's
``--trace-out`` writes Chrome-trace JSON.

Marked ``cuda`` (skipped without a card): a span around one matmul
holds the device start that ``torch.profiler`` reports for it (the
recorder's host clock is the one the profiler converts the device's
timestamps to), and a span counts the kernels launched inside it.

This file imports neither JAX nor the reference package.
"""
import json
import time

import pytest
import torch
import torch.distributed as dist

from repro_torch import timing
from repro_torch.core.codec import codec_for_scheme
from repro_torch.core.schemes import QuantScheme
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import TPCtx, tp_all_reduce
from repro_torch.models.transformer import Model
from repro_torch.timing import NO_CLOCK, StageClock
from repro_torch.train.optim import OptimConfig
from repro_torch.train.train_step import TrainConfig, Trainer

# one thread: xdist workers that each take every core starve one another
torch.set_num_threads(1)

TINY = ModelConfig(name="tiny", arch_type="dense", num_layers=2, d_model=64,
                   num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
                   vocab_size=256, qk_norm=True, compute_dtype="float32",
                   param_dtype="float32")
M = 2

# the stages of each wire's update step and steady step, as the trainer
# marked them before the recorder; fp32's mean is the new ``collective``
STAGES = {
    "all_gather": (["grad", "stats", "encode", "pack", "collective",
                    "unpack", "decode", "optimizer"],
                   ["grad", "encode", "pack", "collective", "unpack",
                    "decode", "optimizer"]),
    "two_phase": (["grad", "stats", "encode", "checksum", "pack",
                   "collective", "unpack", "decode", "requant",
                   "optimizer"],
                  ["grad", "encode", "checksum", "pack", "collective",
                   "unpack", "decode", "requant", "optimizer"]),
    "fp32": (["grad", "collective", "optimizer"],
             ["grad", "collective", "optimizer"]),
}
WIRE = {"all_gather": {"encode", "quantize", "pack", "collective", "decode",
                       "unpack"},
        "two_phase": {"encode", "quantize", "checksum", "pack", "collective",
                      "decode", "unpack", "requant"},
        "fp32": {"collective"}}


@pytest.fixture(autouse=True)
def fresh():
    timing.reset()
    yield
    timing.reset()


def _trainer(mode):
    model = Model(TINY, device="cpu", seed=0)
    scheme = QuantScheme(name="fp32" if mode == "fp32" else "alq", bits=3,
                         bucket_size=256)
    return Trainer(model, TrainConfig(
        scheme=scheme, optim=OptimConfig(name="adamw", lr=1e-3),
        sync_mode=mode, workers=M, update_milestones=(0,), update_every=0,
        integrity=mode == "two_phase"), seed=0)


def _batch(seed=0):
    ids = torch.randint(0, TINY.vocab_size, (2 * M, 33),
                        generator=torch.Generator().manual_seed(seed))
    return {"ids": ids[:, :-1], "labels": ids[:, 1:]}


def _hooks(model) -> int:
    return sum(len(m._forward_hooks) + len(m._forward_pre_hooks)
               for m in model.modules())


def test_spans_nest_with_parents_and_self_time():
    with timing.recording("cpu", step=7):
        with timing.span("outer", worker=3, tag="a") as outer:
            time.sleep(0.002)
            with timing.span("inner", device=True) as inner:
                timing.count("chunks", 2)
                timing.count("chunks")
                time.sleep(0.003)
            timing.count("bytes", 5)
        with timing.span("sibling"):
            pass
    spans = {s.name: s for s in timing.recorded()}
    assert set(spans) == {"step", "outer", "inner", "sibling"}
    step = spans["step"]
    assert step.parent is None and step.step == 7
    assert outer.parent == step.id and spans["sibling"].parent == step.id
    assert inner.parent == outer.id
    # a span without a worker takes its parent's
    assert (outer.worker, inner.worker, spans["sibling"].worker) == (3, 3,
                                                                     None)
    assert outer.attrs == {"tag": "a"}
    assert inner.counters == {"chunks": 3} and outer.counters == {"bytes": 5}
    assert outer.t0 <= inner.t0 < inner.t1 <= outer.t1 <= step.t1
    assert inner.host_ns >= 3e6
    assert outer.self_ns == outer.host_ns - inner.host_ns >= 2e6
    assert step.self_ns == (step.host_ns - outer.host_ns
                            - spans["sibling"].host_ns)
    # a device span on the CPU: its device time is the host's
    assert inner.ms() == pytest.approx(inner.host_ns * 1e-6)
    assert outer.ms() is None


def test_recorded_keeps_the_last_steps():
    for k in range(timing.KEEP_STEPS + 3):
        with timing.recording("cpu", step=k):
            pass
    steps = [s.step for s in timing.recorded()]
    assert steps == list(range(3, timing.KEEP_STEPS + 3))
    timing.reset()
    assert timing.recorded() == []


def test_no_clock_records_nothing(monkeypatch):
    made = []

    class Event:
        def __init__(self, **kw):
            made.append(self)

        def record(self):
            pass

        def elapsed_time(self, other):
            return 0.0

    monkeypatch.setattr(torch.cuda, "Event", Event)
    # the stand-in sees the events of a recording on a card: the clock's
    # start and a device span's two ends
    with timing.recording("cuda"):
        with timing.span("x", device=True):
            pass
    assert len(made) == 3
    timing.reset()
    made.clear()

    trainer = _trainer("all_gather")
    hooks = _hooks(trainer.model)
    for t in range(2):
        trainer.train_step(_batch(t), clock=NO_CLOCK)
        assert _hooks(trainer.model) == hooks
    assert timing.recorded() == [] and not made
    assert timing.span("a") is timing.span("b", device=True, worker=1)
    timing.count("bytes", 1)        # nothing open: nothing to add to
    assert timing._REC.spans is None and timing._REC.stack == []


@pytest.mark.parametrize("mode", ["all_gather", "two_phase", "fp32"])
def test_train_step_records_its_spans(mode):
    trainer = _trainer(mode)
    model = trainer.model
    hooks = _hooks(model)
    got = []
    for t in range(2):
        clock = StageClock("cpu")
        m = trainer.train_step(_batch(t), clock=clock)
        got.append(list(clock.stage_ms()))
        assert _hooks(model) == hooks       # the step's hooks are gone
        assert all(v >= 0 for v in clock.stage_ms().values())
    assert tuple(got) == STAGES[mode]
    spans = timing.recorded()
    by_id = {s.id: s for s in spans}
    steady = [s for s in spans if s.step == 1 and s.kind == "span"]
    step, = [s for s in steady if s.name == "step"]
    assert step.counters["tokens"] == 2 * M * 32
    for name in ("forward", "backward"):
        assert sorted(s.worker for s in steady if s.name == name) == [0, 1]
        assert all(s.parent == step.id and s.device for s in steady
                   if s.name == name)
    # the model's spans: a block a slot in each forward, its replay by
    # the checkpoint in each backward
    for s in steady:
        if s.name in ("embed", "block", "loss"):
            assert by_id[s.parent].name == "forward"
        if s.name == "recompute":
            assert by_id[s.parent].name == "backward" and s.device
    for kind in ("block", "recompute"):
        for w in range(M):
            assert sorted(s.attrs["slot"] for s in steady
                          if s.name == kind and s.worker == w) == [0, 1]
    loss = [s for s in steady if s.name == "loss"]
    assert len(loss) == M and all(s.counters["chunks"] == 1 for s in loss)
    names = {s.name for s in steady}
    assert WIRE[mode] <= names and "optimizer" in names
    # the level update's spans on its step alone (fp32 fits no levels)
    assert not {"stats", "fit"} & names
    assert ({"stats", "fit"} <= {s.name for s in spans if s.step == 0}) == (
        mode != "fp32")
    # the wire's bytes, as the plan reckons them
    moved = sum(s.counters.get("bytes", 0) for s in steady
                if s.name == "collective")
    assert moved == pytest.approx(M * m["comm_bits_per_coord"] * model.d / 8,
                                  rel=1e-12)
    if mode != "fp32":
        for name in ("pack", "unpack"):
            assert all(s.counters["chunks"] >= 1 for s in steady
                       if s.name == name)
        assert all(by_id[s.parent].name == "encode" for s in steady
                   if s.name == "quantize" and by_id[s.parent].name !=
                   "requant")
    if mode == "two_phase":
        # the encode's checksum and the decode's, per stream, apart
        parents = {by_id[s.parent].name for s in steady
                   if s.name == "checksum"}
        assert parents == {"encode", "decode", "requant"}
        assert all("stream" in s.attrs for s in steady
                   if s.name == "checksum" and by_id[s.parent].name
                   == "decode")
    stages = [s for s in spans if s.kind == "stage" and s.step == 1]
    assert [s.name for s in stages][-1] == "optimizer"
    assert all(s.parent is None for s in stages)


def test_tp_all_reduce_is_a_span(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        ctx = TPCtx.over(dist.group.WORLD)
        x = torch.ones(3, 5)
        with timing.recording("cpu"):
            tp_all_reduce(x, ctx.group, "sum")
            tp_all_reduce(x[0], ctx.group, "max")
    finally:
        dist.destroy_process_group()
    tot = timing.totals("tp_all_reduce")
    assert tot["calls"] == 2 and tot["bytes"] == (15 + 5) * 4
    assert tot["ms"] >= 0.0


def test_launcher_writes_a_chrome_trace(tmp_path):
    from repro_torch.launch import train
    out = tmp_path / "spans.json"
    t0 = time.time_ns()
    res = train.run(train.parse_args([
        "--device", "cpu", "--workers", "2", "--steps", "2", "--batch", "4",
        "--seq", "16", "--update-at", "0", "--trace-out", str(out)]))
    assert "stage_ms" not in res["history"][0]  # --time-stages's alone
    events = json.loads(out.read_text())["traceEvents"]
    spans = [e for e in events if e["ph"] == "X"]
    steps = [e for e in spans if e["name"] == "step"]
    assert [e["args"]["step"] for e in steps] == [0, 1]
    assert all(t0 / 1e3 <= e["ts"] <= time.time_ns() / 1e3 for e in spans)
    fwd = [e for e in spans if e["name"] == "forward"]
    assert len(fwd) == 4 and all("device_ms" in e["args"] for e in fwd)
    coll = [e for e in spans if e["name"] == "collective"
            and e["cat"] == "span"]
    assert coll and all(e["args"]["bytes"] > 0 for e in coll)
    assert {e["tid"] for e in spans if e["cat"] == "stage"} == {1}


# ---- on the card ----------------------------------------------------------

# how far after a span's host end the device may start its work and still
# count as inside it: a launch's latency and the profiler's clock
# conversion
SLACK_NS = 1_000_000


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_spans_share_the_profilers_clock(dev):
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(8192, 8192, device=dev, generator=g)
    b = torch.randn(8192, 8192, device=dev, generator=g)
    a @ b                               # cuBLAS's handle and workspace
    torch.cuda.synchronize()
    offsets = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with timing.recording(dev):
                torch.cuda.synchronize()     # the device idle
                with timing.span("matmul", device=True) as s:
                    a @ b
            torch.cuda.synchronize()
        kernels = [e for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA]
        mm = max(kernels, key=lambda e: e.duration_ns())
        start = mm.start_ns()
        offsets.append((start - s.t0, s.t1 - s.t0, mm.duration_ns()))
        assert s.t0 <= start <= s.t1 + SLACK_NS, offsets
    print(f"matmul device start - span host start, span length, kernel "
          f"length (ns): {offsets} ({torch.cuda.get_device_name(0)})")


@pytest.mark.cuda
def test_spans_count_the_launches(dev):
    from repro_torch.kernels import cuda
    cuda.build()
    codec = codec_for_scheme(QuantScheme(name="alq", bits=3,
                                         bucket_size=1024))
    vb = torch.randn(64, 1024, device=dev)
    levels = torch.linspace(0, 1, 4, device=dev)
    before = sum(cuda.LAUNCHES.values())
    with timing.recording(dev):
        with timing.span("encode"):
            p = codec.encode(vb, levels, generator=torch.Generator(
                device=dev).manual_seed(0))
        with timing.span("decode"):
            codec.decode(p, levels, codec.plan_buckets(64))
    spans = timing.recorded()
    launched = sum(s.counters.get("launches", 0) for s in spans)
    assert launched == sum(cuda.LAUNCHES.values()) - before >= 2
    assert {s.name for s in spans if s.counters.get("launches")} == {
        "quantize", "decode"}

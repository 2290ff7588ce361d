"""The harness on the card at test sizes: a run and a traced run through
``run_cell``, the trace reduced to every per-layer metric."""
import json
import time

import pytest
import torch

from conftest import ROOT, tiny_cell
from harness import cells, roofline, run, shapes, trace

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def _cell(traced):
    entries = SPEC["per_layer"] if traced else SPEC["end_to_end"]
    c = tiny_cell("attn", "all_gather", {"loss": 1e-3, "grad1": 1e-2,
                                         "delta": 1e-2})
    metrics = [cells.Metric(e["name"], e["unit"], cells.load_reader(e["name"]))
               for e in entries]
    return c._replace(**{("per_layer" if traced else "end_to_end"): metrics})


@pytest.mark.cuda
def test_run_on_the_card(card):
    res = run.run_cell(_cell(False), 3, 1.0, False, card, roofline.H100,
                       time.perf_counter())
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert m["tokens_per_s"]["value"] > 0 and m["peak_mem_gib"]["value"] > 0
    assert 4.0 < m["wire_bits_per_coord"]["value"] < 6.0


@pytest.mark.cuda
def test_traced_run_on_the_card(card):
    res = run.run_cell(_cell(True), 3, 1.0, True, card, roofline.H100,
                       time.perf_counter())
    assert res["correct"], res["checks"]
    assert 0 < res["busy_s"] <= res["window_s"]
    m = res["metrics"]
    for name in ("launches_per_step", "grad_ms", "wire_ms", "optimizer_ms",
                 "device_idle_share", "quantize_roofline",
                 "dequantize_mean_roofline", "step_mfu"):
        assert name in m, name
    assert 0 < m["quantize_roofline"]["value"] <= 105
    names = [n for n, _ in res["breakdown"]["device_ops"]]
    assert names and not any(n.startswith("bench.") for n in names)
    torch.cuda.synchronize()


def test_breakdown_names_gaps_by_stage():
    ctx = trace.TraceContext(
        steps=1, ops=[("k1", 100, 50, "kernel"), ("k2", 300, 100, "kernel"),
                      ("Memcpy HtoD", 120, 10, "gpu_memcpy")],
        stage_ms=[{"grad": 1.0, "optimizer": 0.5}], window_s=5e-7,
        busy_s=1.5e-7, marks=[(200, "grad"), (450, "optimizer")],
        window_ns=(0, 500), m={}, traffic=None, d=0, peak=roofline.H100)
    b = trace.breakdown(ctx)
    assert b["device_ops"][0] == ["k2", pytest.approx(1e-7)]
    gaps = dict(b["idle_gaps"])
    # 0-100 ends before the grad mark, 150-300 before the optimizer's,
    # 400-500 before none
    assert gaps == pytest.approx({"grad": 1e-7, "optimizer": 1.5e-7,
                                  "end of window": 1e-7})
    assert len(ctx.kernels) == 2
    assert trace._union([(0, 5), (3, 8), (10, 12)]) == [[0, 8], [10, 12]]


@pytest.mark.parametrize("mode", ["all_gather", "two_phase", "fp32"])
def test_roofline_readers_count_their_launches(mode):
    """A reader reads only where the trace holds the launches the wire
    makes (all_gather: M quantizes and one dequantize_mean a step;
    two_phase: 2M and M), and then least time over device time."""
    tr = tiny_cell("attn", mode).traffic
    d, M = 106880, tr.workers
    q = cells.load_reader("quantize_roofline")
    dm = cells.load_reader("dequantize_mean_roofline")
    nq, ndm = {"all_gather": (M, 1), "two_phase": (2 * M, M),
               "fp32": (0, 0)}[mode]

    def ctx(n_q, n_dm, ns=1000):
        ops = ([("void repro::quantize_regs<float>", 0, ns, "kernel")] * n_q
               + [("void repro::mean_vec<signed char>", 0, ns, "kernel")]
               * n_dm + [("void repro::dequantize_vec<a>", 0, ns, "kernel")])
        return trace.TraceContext(
            steps=2, ops=ops, stage_ms=[], window_s=1.0, busy_s=0.5,
            marks=[], window_ns=(0, 1), m={}, traffic=tr, d=d,
            peak=roofline.H100)

    if mode == "fp32":
        assert q(ctx(0, 0)) is None and dm(ctx(0, 0)) is None
        return
    assert q(ctx(2 * nq + 1, 2 * ndm)) is None
    assert dm(ctx(2 * nq, 2 * ndm + 1)) is None
    bs = tr.scheme["bucket_size"]
    nb = shapes.wire_buckets(d, bs, M if mode == "two_phase" else 1)
    want = roofline.bound_s(roofline.quantize_bytes(nb, bs, 8))
    if mode == "two_phase":
        want = (want + roofline.bound_s(roofline.quantize_bytes(
            nb // M, bs, 256))) / 2
    assert q(ctx(2 * nq, 2 * ndm)) == pytest.approx(100 * want / 1e-6)
    assert dm(ctx(2 * nq, 2 * ndm)) > 0


ATTN_NAMES = {
    "fwd": "void repro::(anonymous namespace)::attn_fwd<128, __nv_bfloat16>"
           "(repro::(anonymous namespace)::Args)",
    "bwd_dq": "_ZN5repro12_GLOBAL__N_111attn_bwd_dqILi128E13__nv_bfloat16S2_"
              "EEvNS0_4ArgsE",
    "bwd_dkv": "void repro::(anonymous namespace)::attn_bwd_dkv<128, "
               "__nv_bfloat16, __nv_bfloat16>(repro::(anonymous namespace)"
               "::Args)"}


@pytest.mark.parametrize("kind", ["attn", "window", "rwkv"])
def test_attention_roofline_counts_its_launches(kind):
    """Each attention layer a worker launches the forward twice a step and
    each backward kernel once; the least time is each slot's FLOPs at its
    window.  Another count, or a configuration with no attention kernel,
    reads nothing."""
    from conftest import TINY
    read = cells.load_reader("attention_roofline")
    m, tr = TINY[kind], tiny_cell("attn").traffic
    L, M = m["num_layers"], tr.workers

    def ctx(n_fwd, n_bwd, ns=1000):
        ops = ([(ATTN_NAMES["fwd"], 0, ns, "kernel")] * n_fwd
               + [(ATTN_NAMES[k], 0, ns, "kernel")
                  for k in ("bwd_dq", "bwd_dkv")] * n_bwd
               + [("void at::native::attn_fwd_lookalike", 0, ns, "kernel")])
        return trace.TraceContext(
            steps=2, ops=ops, stage_ms=[], window_s=1.0, busy_s=0.5,
            marks=[], window_ns=(0, 1), m=m, traffic=tr, d=0,
            peak=roofline.H100)

    n = 2 * M * L
    if kind == "rwkv":
        assert read(ctx(2 * n, n)) is None
        return
    assert read(ctx(2 * n + 1, n)) is None
    assert read(ctx(2 * n, n - 1)) is None
    B, S, H, hd = tr.rows_per_worker, tr.seq_len, m["num_heads"], m["head_dim"]
    windows = [m.get("window", 0), 0] * (L // 2) if kind == "window" else [0] * L
    flops = sum(2 * f + b for f, b in (
        roofline.attention_flops(B, S, H, hd, w) for w in windows))
    want = 2 * M * flops / roofline.H100.bf16_flops
    assert read(ctx(2 * n, n)) == pytest.approx(100 * want / (4 * n * 1e-6))

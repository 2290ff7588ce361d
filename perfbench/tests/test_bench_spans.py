"""The readers of the program's spans (``harness/spans.py``): a
synthetic trace and synthetic spans give known values for
``forward_ms``, ``backward_ms``, ``recompute_ms``, ``grad_idle_ms`` and
``wire_idle_ms``, and a program that records no spans gives None."""
import pytest

from harness import cells, roofline, trace
from repro_torch import timing

READERS = ("forward_ms", "backward_ms", "recompute_ms", "grad_idle_ms",
           "wire_idle_ms")


def _span(name, sid, parent, step, t0, t1, ms=None, kind="span"):
    return timing.Span(name, sid, parent, step, None, t0, t1, kind=kind,
                       device=ms is not None, device_ms=ms)


def _spans():
    """Two clocked steps (0, 1) before the window at 1000 ns, two
    profiled ones (2, 3) inside it."""
    out, ids = [], iter(range(1000))

    def step(k, t, fwd, bwd, rec):
        sid = next(ids)
        out.append(_span("step", sid, None, k, t, t + 900))
        f, b = next(ids), next(ids)
        out.append(_span("forward", f, sid, k, t, t + 300, fwd))
        out.append(_span("block", next(ids), f, k, t + 50, t + 250))
        out.append(_span("backward", b, sid, k, t + 300, t + 600, bwd))
        out.append(_span("recompute", next(ids), b, k, t + 350, t + 400,
                         rec))
        out.append(_span("encode", next(ids), sid, k, t + 600, t + 650))
        out.append(_span("collective", next(ids), sid, k, t + 650, t + 700))
        d = next(ids)
        out.append(_span("decode", d, sid, k, t + 700, t + 800))
        # a wire span under the decode: covered by it, counted once
        out.append(_span("unpack", next(ids), d, k, t + 710, t + 790))
        out.append(_span("optimizer", next(ids), sid, k, t + 800, t + 890))
        out.append(_span("grad", next(ids), None, k, t, t + 600, 1.0,
                         kind="stage"))

    step(0, -2000, 10.0, 30.0, 4.0)
    step(1, 0, 14.0, 34.0, 6.0)
    step(2, 1000, 99.0, 99.0, 99.0)
    step(3, 2000, 99.0, 99.0, 99.0)
    return out


def _ctx():
    # the device busy over [1000, 1200), [1500, 1700), [1760, 1790) and
    # the whole second profiled step but [2620, 2680)
    ops = [("k", 1000, 200, "kernel"), ("k", 1500, 200, "kernel"),
           ("k", 1760, 30, "kernel"), ("k", 1900, 720, "kernel"),
           ("k", 2680, 320, "kernel")]
    return trace.TraceContext(
        steps=2, ops=ops, stage_ms=[], window_s=2e-6, busy_s=0.0, marks=[],
        window_ns=(1000, 3000), m={}, traffic=None, d=0, peak=roofline.H100)


def test_readers_read_the_spans(monkeypatch):
    monkeypatch.setattr(timing, "recorded", _spans)
    got = {n: cells.load_reader(n)(_ctx()) for n in READERS}
    want = {
        "forward_ms": (10.0 + 14.0) / 2,
        "backward_ms": (30.0 + 34.0) / 2,
        "recompute_ms": (4.0 + 6.0) / 2,
        # idle [1200, 1500) inside forward and backward [1000, 1600)
        "grad_idle_ms": 300e-6 / 2,
        # idle [1700, 1760) and [1790, 1800) inside the wire's [1600,
        # 1800), and [2620, 2680) inside the second step's encode and
        # collective; the idle [1800, 1900) lies in the optimizer
        "wire_idle_ms": (60 + 10 + 60) * 1e-6 / 2,
    }
    assert got == pytest.approx(want)


@pytest.mark.parametrize("recorded", [None, "empty"])
def test_readers_read_nothing_without_spans(monkeypatch, recorded):
    if recorded is None:      # a program whose recorder keeps no spans
        monkeypatch.delattr(timing, "recorded")
    else:
        monkeypatch.setattr(timing, "recorded", lambda: [])
    for n in READERS:
        assert cells.load_reader(n)(_ctx()) is None

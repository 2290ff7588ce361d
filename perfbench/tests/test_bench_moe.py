"""The MoE layer kind (``layers/moe.py``) and its configuration,
Mellum2-12B-A2.5B at one period of 4 layers with the card's 32 of 64
experts: how the configuration resolves and lays out, the kind with
``window.py`` against the port's ``Model`` on the CPU, the controls that
comparison must catch, and the readers of ``moe_ms`` and
``experts_roofline``."""
import copy
import json

import pytest
import torch

from conftest import ROOT
from harness import cells, roofline, shapes, system
import layers
from layers import moe, window
from repro_torch import timing
from test_bench_layers import _gaps

CONFIG = json.loads(
    (ROOT / "perfbench/configs/mellum2-12b-a2.5b-4l.json").read_text())
CELL = "mellum2-12b-a2.5b-4l.alq3-allgather-1x8192"
# one period at test widths: 3 slots of window 16 (at S = 64) then a full
# one, each FFN 8 experts of which 4 held, top-2; float32 on both sides
TINY = {"name": "tiny-moe", "arch_type": "moe", "num_layers": 4,
        "d_model": 64, "num_heads": 4, "num_kv_heads": 2, "head_dim": 16,
        "d_ff": 32, "vocab_size": 256, "rope_theta": 5e5, "norm_eps": 1e-6,
        "attn_kind": "sliding", "window": 16, "full_attn_every": 4,
        "moe": True, "num_experts": 8, "experts_held": 4, "top_k": 2,
        "capacity_factor": 1.25, "router_aux_coef": 0.0,
        "compute_dtype": "float32", "param_dtype": "float32"}
# Both sides float32.  The port runs the blockwise _flash and batched
# expert products over the padded capacity, the reference one softmax and
# one product an expert, so sums run in other orders: over seeds 1-6, 11
# and 2**31 + 5 the loss differs by <= 8.0e-8 of itself and a leaf's
# gradient by <= 1.35e-6 of its norm.  Every control moves the loss by
# 8.1e-4 or more and the worst leaf by 1.2 of its norm or more (seeds 1,
# 2, 3, 11), so the limits leave two orders of magnitude on each side.
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4


def _kinds(m):
    return [tuple(layers.name(k) for k in s) for s in shapes.slots(m)]


def test_configuration_resolves():
    m = CONFIG["model"]
    assert _kinds(m) == [("window", "moe")] * 4      # no unread key
    assert [window.window_of(m, j) for j in range(4)] == [1024] * 3 + [0]
    cell = cells.resolve(CELL)
    assert cell.model == m and cell.traffic.tokens_per_step == 4 * 8192
    assert moe.capacity(m, 8192) == 1280


def test_configuration_states_its_cut():
    """The file holds the catalog's keys as run: each equal to the
    published value but the keys ``reduced`` names; the port's numbers
    are those keys'."""
    pub, m = CONFIG["published"], CONFIG["model"]
    changed = {k for k in pub if CONFIG[k] != pub[k]}
    assert changed == set(CONFIG["reduced"]) == {
        "num_hidden_layers", "num_experts", "rope_parameters"}
    assert (CONFIG["num_hidden_layers"], pub["num_hidden_layers"]) == (4, 28)
    assert (CONFIG["num_experts"], pub["num_experts"]) == (32, 64)
    assert pub["layer_types"][:4] == ["sliding_attention"] * 3 + [
        "full_attention"]
    assert set(pub["mlp_layer_types"]) == {"sparse"}
    assert (m["num_layers"], m["experts_held"], m["num_experts"]) == (
        CONFIG["num_hidden_layers"], CONFIG["num_experts"],
        pub["num_experts"])
    for key, ours in (("hidden_size", "d_model"), ("head_dim", "head_dim"),
                      ("num_attention_heads", "num_heads"),
                      ("num_key_value_heads", "num_kv_heads"),
                      ("moe_intermediate_size", "d_ff"),
                      ("vocab_size", "vocab_size"),
                      ("num_experts_per_tok", "top_k"),
                      ("sliding_window", "window"),
                      ("rms_norm_eps", "norm_eps")):
        assert m[ours] == pub[key], key
    assert m["rope_theta"] == pub["rope_parameters"]["sliding_attention"][
        "rope_theta"]
    assert m["full_attn_every"] == pub["layer_types"].index(
        "full_attention") + 1


def test_leaves_and_coordinates_are_the_ports():
    from repro_torch.models.transformer import param_layout
    m = CONFIG["model"]
    got = [(lf.name, lf.shape) for lf in shapes.leaves(m)]
    assert got == [(n, tuple(s)) for n, s, _ in param_layout(
        system.model_config(m))]
    assert [n for n, _ in got[3:13]] == [
        "slots.0.ffn.router", "slots.0.ffn.w1", "slots.0.ffn.w2",
        "slots.0.ffn.w3", "slots.0.mixer.wk", "slots.0.mixer.wo",
        "slots.0.mixer.wq", "slots.0.mixer.wv", "slots.0.norm1",
        "slots.0.norm2"]
    assert dict(got)["slots.3.ffn.w2"] == (1, 1, 32, 896, 2304)
    assert shapes.coordinates(m) == 1_331_253_504 == (
        452_984_832 + 4 * 219_566_592 + 2304)
    assert sum(lf.numel for lf in shapes.leaves(m)
               if lf.name.split(".")[-1] in ("w1", "w2", "w3")
               and ".ffn." in lf.name) == 4 * 198_180_864
    # the router and 4 of a token's 8 experts on this card, a layer
    assert moe.active(m, 0) == 2304 * 64 + 4 * 3 * 2304 * 896
    assert shapes.param_count(m) == system.model_config(
        m).active_param_count()


@pytest.mark.parametrize("change", [
    {"router_aux_coef": 0.01}, {"shared_expert": True}, {"moe_every": 2},
    {"experts_held": 3}, {"experts_held": 16}], ids=lambda c: "-".join(c))
def test_what_the_kind_does_not_compute_is_refused(change):
    with pytest.raises(ValueError):
        shapes.slots({**TINY, **change})
    aux = {k: v for k, v in TINY.items() if k != "router_aux_coef"}
    with pytest.raises(ValueError, match="router_aux_coef"):
        shapes.slots(aux)          # the port's default aux loss, 0.01


@pytest.mark.parametrize("seed", [11, 2 ** 31 + 5])
def test_moe_and_window_match_the_port(seed):
    loss, grad = _gaps(TINY, seed)
    assert loss <= LOSS_TOL and grad <= GRAD_TOL, (loss, grad)


_forward, _route = moe.forward, moe.route


def _every_expert_held(ref, p, h, slot):
    """The reference computing the other card's pairs too (its experts
    standing in for the absent ones)."""
    r = ref.m["num_experts"] // moe.held(ref.m)
    whole = copy.copy(ref)
    whole.m = {**ref.m, "experts_held": ref.m["num_experts"]}
    return _forward(whole, {**p, **{k: p[k].repeat(r, 1, 1)
                                    for k in ("w1", "w2", "w3")}}, h, slot)


def _unnormalised(probs, k):
    gate, expert = _route(probs, k)
    return torch.gather(probs, 1, expert), expert


@pytest.mark.parametrize("control", [
    (moe, "forward", _every_expert_held),
    (moe, "route", _unnormalised),
    (window, "window_of", lambda m, slot: 0),
], ids=["every_expert_held", "gates_not_renormalised", "no_window"])
def test_controls_fail(control, monkeypatch):
    monkeypatch.setattr(*control)
    loss, grad = _gaps(TINY, 11)
    assert loss > LOSS_TOL or grad > GRAD_TOL, (loss, grad)


# ---- the readers, on synthetic spans -------------------------------------

def _span(name, sid, parent, step, t0, t1, ms=None, **counters):
    return timing.Span(name, sid, parent, step, None, t0, t1,
                       device=ms is not None, device_ms=ms,
                       counters=counters)


def _spans(moe_spans=True, pairs=True):
    """Two clocked steps (0, 1) before the window at 1000 ns, each with a
    forward MoE and its replay, and two profiled ones (2, 3)."""
    out, ids = [], iter(range(1000))
    steps = ((0, -3000, [(10.0, 4.0, 900), (11.0, 5.0, 1000)]),
             (1, -1000, [(12.0, 6.0, 1100), (13.0, 7.0, 1000)]),
             (2, 1000, [(99.0, 99.0, 1)] * 2), (3, 2000, [(99.0, 99.0, 1)] * 2))
    for k, t, layers_ in steps:
        sid = next(ids)
        out.append(_span("step", sid, None, k, t, t + 900))
        if not moe_spans:
            continue
        for moe_ms, experts_ms, kept in layers_:
            m = next(ids)
            out.append(_span("moe", m, sid, k, t + 10, t + 90, moe_ms,
                             **({"pairs": kept, "dropped": 3}
                                if pairs else {})))
            out.append(_span("experts", next(ids), m, k, t + 20, t + 80,
                             experts_ms))
    return out


def _ctx():
    return type("Ctx", (), dict(
        steps=2, window_ns=(1000, 3000), m=TINY, peak=roofline.H100))()


def test_readers_read_the_moe_spans(monkeypatch):
    monkeypatch.setattr(timing, "recorded", _spans)
    ctx = _ctx()
    assert cells.load_reader("moe_ms")(ctx) == pytest.approx(
        (10.0 + 11.0 + 12.0 + 13.0) / 2)
    flops = 6 * 64 * 32 * (900 + 1000 + 1100 + 1000)
    seconds = (4.0 + 5.0 + 6.0 + 7.0) * 1e-3
    assert cells.load_reader("experts_roofline")(ctx) == pytest.approx(
        100.0 * flops / seconds / 989.4e12)


@pytest.mark.parametrize("spans", [None, "empty", "no_moe", "no_pairs"])
def test_readers_read_nothing_without_moe_spans(monkeypatch, spans):
    if spans is None:       # a program whose recorder keeps no spans
        monkeypatch.delattr(timing, "recorded")
    else:
        got = {"empty": [], "no_moe": _spans(moe_spans=False),
               "no_pairs": _spans(pairs=False)}[spans]
        monkeypatch.setattr(timing, "recorded", lambda: got)
    assert cells.load_reader("experts_roofline")(_ctx()) is None
    if spans != "no_pairs":
        assert cells.load_reader("moe_ms")(_ctx()) is None

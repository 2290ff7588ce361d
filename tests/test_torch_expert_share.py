"""The card's share of an MoE layer's experts (``ModelConfig.experts_held``)
and the MoE layer's spans and counters (``models/moe.py``, ``timing``).

With the share the card holds the first ``experts_held`` experts, routes
over all of them and computes only the pairs routed to its block, as one
card of an expert-parallel group does.  The test that ties the share to
the layer: roll the router's columns so that block b comes first and give
the share block b's experts; summed over the blocks, the shares' outputs
and the gradients of x and of every leaf are the uncut layer's (float32;
the sums over a token's k slots run in another order, so within 1e-5 of
the largest entry, as ``test_torch_moe.py`` holds the layer to the
reference).  The router's gradient is the sum of the blocks', rolled
back.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import timing
from repro_torch.launch.dryrun import model_flops_per_device
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Model, param_layout

# one thread: xdist workers that each take every core starve one another
torch.set_num_threads(1)

# one period of Mellum2's layers at test widths: 3 sliding slots, then a
# full one; every FFN an MoE of 8 experts, top-2, the card holding 4
WHOLE = ModelConfig(
    name="tiny-moe", arch_type="moe", num_layers=4, d_model=32, num_heads=4,
    num_kv_heads=2, head_dim=8, d_ff=48, vocab_size=64, attn_kind="sliding",
    window=8, full_attn_every=4, moe=True, num_experts=8, top_k=2,
    router_aux_coef=0.0, norm_eps=1e-6, compute_dtype="float32")
SHARE = dataclasses.replace(WHOLE, experts_held=4)
# Mellum2-12B-A2.5B at one period of 4 layers, 32 of its 64 experts held
MELLUM = ModelConfig(
    name="mellum2", arch_type="moe", num_layers=4, d_model=2304,
    num_heads=32, num_kv_heads=4, head_dim=128, d_ff=896, vocab_size=98304,
    attn_kind="sliding", window=1024, full_attn_every=4, moe=True,
    num_experts=64, top_k=8, experts_held=32, router_aux_coef=0.0)


def _leaves(cfg, seed):
    g = torch.Generator().manual_seed(seed)
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.d_ff

    def w(*shape, fan):
        return torch.randn(*shape, generator=g) * fan ** -0.5

    return {"router": w(d, E, fan=d), "w1": w(E, d, ff, fan=d),
            "w3": w(E, d, ff, fan=d), "w2": w(E, ff, d, fan=ff)}


def _run(cfg, p, x, dy):
    """moe_ffn's output and the gradients of x and of each leaf for the
    upstream gradient dy."""
    p = {k: v.clone().requires_grad_() for k, v in p.items()}
    x = x.clone().requires_grad_()
    y, _ = moe.moe_ffn(cfg, p, x)
    (y * dy).sum().backward()
    return y.detach(), x.grad, {k: v.grad for k, v in p.items()}


@pytest.mark.parametrize("held", [1, 2, 4, 8])
def test_share_lays_out_its_block(held):
    cfg = dataclasses.replace(WHOLE, experts_held=held)
    got, whole = param_layout(cfg), param_layout(WHOLE)
    assert [n for n, _, _ in got] == [n for n, _, _ in whole]
    for (name, shape, code), (_, wshape, wcode) in zip(got, whole):
        assert code == wcode
        if name.rsplit(".", 1)[-1] in ("w1", "w2", "w3"):
            assert shape == (1, 1, held, *wshape[3:]), name
        else:
            assert shape == wshape, name


def test_share_counts():
    """param_count: the embedding and head, each layer's attention, its
    router and its held experts; active_param_count: the router and the
    top_k * held / E experts a token has on this card; the dry run's
    FLOPs are 6 of those a token."""
    d, V, ff, nq, nkv = 32, 64, 48, 32, 16
    mix = d * nq + 2 * d * nkv + nq * d
    assert SHARE.param_count() == 2 * V * d + 4 * (
        mix + d * 8 + 4 * 3 * d * ff)
    assert SHARE.active_param_count() == 2 * V * d + 4 * (
        mix + d * 8 + 1 * 3 * d * ff)
    # without the share, the reference's counts (no router)
    assert WHOLE.param_count() == 2 * V * d + 4 * (mix + 8 * 3 * d * ff)
    assert WHOLE.active_param_count() == 2 * V * d + 4 * (
        mix + 2 * 3 * d * ff)
    shape = types.SimpleNamespace(global_batch=4, seq_len=64, kind="train")
    mesh = types.SimpleNamespace(size=1)
    assert model_flops_per_device(SHARE, shape, mesh) == (
        6 * SHARE.active_param_count() * 4 * 64)


def test_mellum_share_counts():
    """d = 1,331,253,504: 452,984,832 of embedding and head, 4 layers of
    219,566,592 (198,180,864 of them the 32 experts), the final norm."""
    layout = param_layout(MELLUM)
    assert sum(int(np.prod(s)) for _, s, _ in layout) == 1_331_253_504
    experts = sum(int(np.prod(s)) for n, s, _ in layout
                  if n.rsplit(".", 1)[-1] in ("w1", "w2", "w3"))
    assert experts == 4 * 198_180_864
    assert MELLUM.param_count() == 1_331_253_504 - 9 * 2304
    assert MELLUM.active_param_count() == 452_984_832 + 4 * (
        21_233_664 + 2304 * 64 + 4 * 3 * 2304 * 896)


@pytest.mark.parametrize("over", [
    {}, {"capacity_factor": 0.5},
    {"top_k": 1, "experts_held": 2}, {"top_k": 3, "capacity_factor": 0.75},
], ids=["top2", "top2_drop", "top1_held2", "top3_drop"])
def test_shares_add_up_to_the_layer(over):
    whole = dataclasses.replace(WHOLE, **{k: v for k, v in over.items()
                                          if k != "experts_held"})
    share = dataclasses.replace(whole, experts_held=over.get(
        "experts_held", 4))
    El, E = share.experts_held, share.num_experts
    p = _leaves(whole, 3)
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 40, whole.d_model, generator=g)
    dy = torch.randn(2, 40, whole.d_model, generator=g)
    y, dx, dp = _run(whole, p, x, dy)
    sy, sdx, srouter = 0, 0, 0
    for b in range(E // El):
        block = slice(b * El, (b + 1) * El)
        pb = {"router": torch.roll(p["router"], -b * El, 1),
              **{k: p[k][block] for k in ("w1", "w2", "w3")}}
        yb, dxb, dpb = _run(share, pb, x, dy)
        sy, sdx = sy + yb, sdx + dxb
        srouter = srouter + torch.roll(dpb["router"], b * El, 1)
        for k in ("w1", "w2", "w3"):
            torch.testing.assert_close(dpb[k], dp[k][block], rtol=0,
                                       atol=1e-5 * float(dp[k].abs().max()))
    for got, want in ((sy, y), (sdx, dx), (srouter, dp["router"])):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("over", [
    {"experts_held": 3}, {"experts_held": 16}, {"experts_held": -4},
    {"experts_held": 4, "moe": False},
    {"experts_held": 4, "shared_expert": True},
], ids=["not_a_block", "more_than_all", "negative", "no_moe", "shared"])
def test_unsupported_shares_raise(over):
    with pytest.raises(ValueError):
        dataclasses.replace(WHOLE, **over)


def test_share_with_tensor_parallel_raises():
    for call in (lambda: moe.moe_factor(SHARE, 2),
                 lambda: param_layout(SHARE, 2)):
        with pytest.raises(ValueError, match="experts_held"):
            call()
    assert moe.moe_factor(WHOLE, 2) == (2, 1)
    assert moe.moe_factor(SHARE, 1) == (2, 1)


def _hand_counts(cfg, p, x):
    """pairs, dropped, elsewhere and max_load counted pair by pair in
    numpy: top-k of the router's float32 softmax, the lower index first
    among equals, each expert's pairs kept in token order up to C."""
    xt = x.reshape(-1, cfg.d_model).numpy().astype(np.float64)
    logits = xt @ p["router"].numpy().astype(np.float64)
    T, E, k, El = len(xt), cfg.num_experts, cfg.top_k, cfg.experts_held
    C = moe.capacity(cfg, T)
    seen = [0] * E
    out = dict(pairs=0, dropped=0, elsewhere=0)
    for t in range(T):
        for e in np.argsort(-logits[t], kind="stable")[:k]:
            seen[e] += 1
            if e >= El:
                out["elsewhere"] += 1
            elif seen[e] <= C:
                out["pairs"] += 1
            else:
                out["dropped"] += 1
    out["max_load"] = max(seen[:El])
    return out


def test_spans_and_counters_are_recorded():
    cfg = dataclasses.replace(SHARE, capacity_factor=0.5)
    p = {k: v[:4] if k != "router" else v
         for k, v in _leaves(cfg, 5).items()}
    x = torch.randn(2, 48, cfg.d_model,
                    generator=torch.Generator().manual_seed(6))
    timing.reset()
    with timing.recording("cpu"):
        assert timing.active()
        moe.moe_ffn(cfg, p, x)
    spans = timing.recorded()
    (top,) = [s for s in spans if s.name == "moe"]
    inner = [s for s in spans if s.parent == top.id]
    assert [s.name for s in inner] == ["route", "dispatch", "experts",
                                       "combine"]
    assert top.device and all(s.device for s in inner)
    want = _hand_counts(cfg, p, x)
    assert want["dropped"] > 0 and want["elsewhere"] > 0
    assert top.counters == want
    assert all(type(v) is int for v in top.counters.values())
    assert timing.totals("moe", spans)["pairs"] == want["pairs"]


def test_device_counters_resolve_with_the_step():
    timing.reset()
    with timing.recording("cpu"):
        with timing.span("outer"):
            timing.count("n", torch.tensor(3))
            timing.count("n", 2)
            timing.count("n", torch.tensor(4))
    (outer,) = [s for s in timing.recorded() if s.name == "outer"]
    assert outer.counters == {"n": 9} and type(outer.counters["n"]) is int


def test_model_records_each_layers_moe():
    """A training forward and backward of the share's model: each of the
    4 slots' MoE a ``moe`` span inside its ``block`` span, and its replays
    inside ``recompute`` spans (remat "full": the group's checkpoint and
    each slot's own)."""
    model = Model(SHARE, device="cpu", seed=2)
    ids = torch.randint(0, 64, (2, 17), generator=torch.Generator()
                        .manual_seed(2))
    timing.reset()
    with timing.recording("cpu", model=model):
        with timing.span("forward", device=True):
            loss = model.loss(ids[:, :-1], ids[:, 1:])
        with timing.span("backward", device=True):
            loss.backward()
    spans = timing.recorded()
    by_id = {s.id: s for s in spans}
    moes = [s for s in spans if s.name == "moe"]
    forward = [s for s in moes if by_id[s.parent].name == "block"]
    replays = [s for s in moes if by_id[s.parent].name == "recompute"]
    assert len(forward) == 4 and len(replays) >= 4
    assert len(forward) + len(replays) == len(moes)
    assert {s.counters["pairs"] + s.counters["dropped"]
            + s.counters["elsewhere"] for s in moes} == {32 * 2}


def test_nothing_is_recorded_when_not_recording():
    timing.reset()
    assert not timing.active()
    assert timing.span("moe", device=True) is timing.span("route")
    timing.count("pairs", torch.tensor(5))
    p = {k: v[:4] if k != "router" else v
         for k, v in _leaves(SHARE, 7).items()}
    moe.moe_ffn(SHARE, p, torch.randn(1, 16, SHARE.d_model))
    assert timing.recorded() == []

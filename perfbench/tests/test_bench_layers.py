"""The layer kinds under ``layers/``: how a configuration's slots resolve
to them, the sliding-window kind against the port on the CPU, and a new
kind brought as one new file and nothing else."""
import json
import shutil
import subprocess
import sys
import types

import pytest
import torch

from conftest import BENCH, TINY
from harness import shapes, system, weights
import layers
from layers import window
from reference.model import Reference
from reference.step import leaf_views

# the port's float32 _flash against the reference's one softmax, both in
# float32: over seeds 1-6 the loss differs by <= 1.6e-7 of itself, a
# leaf's gradient by <= 2.4e-6 of its norm.  With the window taken out of
# the reference, the loss moves by 1.4e-3 to 2.8e-2 and the worst leaf's
# gradient by 1.1 to 1.7 of its norm over those seeds; on seed 11, 1.3e-2
# and 1.95, and with every slot windowed (no full slot) 6.0e-3 and 0.97
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4


def _kinds(m):
    return [tuple(layers.name(k) for k in s) for s in shapes.slots(m)]


def test_slots_resolve_to_their_kinds():
    assert _kinds(TINY["attn"]) == [("attention", "swiglu")]
    assert _kinds(TINY["rwkv"]) == [("rwkv6", "swiglu")]
    assert _kinds(TINY["window"]) == [("window", "swiglu")] * 2
    assert [window.window_of(TINY["window"], j) for j in (0, 1)] == [16, 0]


def test_sliding_qwen3_is_taken_by_window():
    m = {**TINY["attn"], "attn_kind": "sliding", "window": 16}
    assert _kinds(m) == [("window", "swiglu")]
    assert shapes.leaves(m) == shapes.leaves(TINY["attn"])


@pytest.mark.parametrize("change", [
    {"attn_kind": "chunked"},                   # the port's; no kind computes it
    {"attn_kind": "sliding", "chunk": 16},      # a key no taking kind reads
    {"moe": True, "num_experts": 4},            # an FFN kind not here
    {"qkv_bias": True},
    {"window": 16},                             # read only by a kind not taking
    {"attn_kind": "sliding", "full_attn_every": 3},  # 2 layers, groups of 3
], ids=lambda c: "-".join(c))
def test_resolution_fails_closed(change):
    with pytest.raises(ValueError):
        shapes.slots({**TINY["attn"], **change})


def test_two_kinds_taking_a_slot_are_refused(monkeypatch):
    rival = types.ModuleType("layers.rival")
    rival.ROLE, rival.KEYS = "mixer", ()
    rival.takes = lambda m, slot: True
    monkeypatch.setattr(layers, "KINDS", layers.KINDS + [rival])
    with pytest.raises(ValueError, match="rival"):
        shapes.slots(TINY["attn"])


def _port(m, seed, toks):
    from repro_torch.models.transformer import Model, attach_grads
    model = Model(system.model_config(m), device="cpu", seed=seed)
    weights.fill(model.flat.data, m, seed)
    grad = torch.zeros_like(model.flat)
    attach_grads(model, model.flat, grad)
    loss = model.loss(toks[:, :-1], toks[:, 1:])
    loss.backward()
    return loss.item(), grad


def _reference(m, seed, toks):
    p = weights.make(m, seed, "cpu").requires_grad_()
    loss = Reference(m).loss(leaf_views(p, shapes.leaves(m)), toks[:, :-1],
                             toks[:, 1:])
    loss.backward()
    return loss.item(), p.grad


def _gaps(m, seed):
    """(the loss's gap, the worst leaf's gradient gap), each over the
    reference's, of the port against the reference on 2 rows of 64."""
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, m["vocab_size"], (2, 65), generator=gen)
    lp, gp = _port(m, seed, toks)
    lr, gr = _reference(m, seed, toks)
    worst = max(
        float((gp[lf.offset:lf.offset + lf.numel]
               - gr[lf.offset:lf.offset + lf.numel]).norm()
              / gr[lf.offset:lf.offset + lf.numel].norm())
        for lf in shapes.leaves(m))
    return abs(lp - lr) / abs(lr), worst


@pytest.mark.parametrize("seed", [11, 2 ** 31 + 5])
def test_window_matches_the_port(seed):
    loss, grad = _gaps(TINY["window"], seed)
    assert loss <= LOSS_TOL and grad <= GRAD_TOL, (loss, grad)


@pytest.mark.parametrize("control", {
    "no_window": lambda m, slot: 0,
    "no_full_slot": lambda m, slot: m["window"],
}.items(), ids=lambda c: c[0])
def test_window_control_fails(control, monkeypatch):
    """The reference with the window taken out (every slot full), or with
    every slot windowed, is caught by the same tolerance."""
    monkeypatch.setattr(window, "window_of", control[1])
    loss, grad = _gaps(TINY["window"], 11)
    assert loss > LOSS_TOL or grad > GRAD_TOL, (loss, grad)


TOY = '''\
"""A toy FFN: w_out(gelu(x w_in)), w_out drawn at half its scale."""
import torch.nn.functional as F

ROLE = "ffn"
KEYS = ("d_ff", "toy_gelu")
DRAWS = {"half": lambda view, gen, fan_in: view.mul_(0.5 * fan_in ** -0.5)}


def takes(m, slot):
    return bool(m.get("toy_gelu"))


def leaves(m, slot):
    d, ff = m["d_model"], m["d_ff"]
    return {"w_in": ((d, ff), "normal", d), "w_out": ((ff, d), "half", ff)}


def active(m, slot):
    return 2 * m["d_model"] * m["d_ff"]


def forward(ref, p, x, slot):
    return ref.mm(F.gelu(ref.mm(x, p["w_in"])), p["w_out"])
'''

DRIVE = '''\
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import layers
from harness import shapes, weights
from reference.model import Reference
from reference.step import leaf_views
m = json.loads(sys.argv[2])
kinds = [[layers.name(k) for k in s] for s in shapes.slots(m)]
leaves = shapes.leaves(m)
p = weights.make(m, 3, "cpu").requires_grad_()
toks = torch.randint(0, m["vocab_size"], (2, 65),
                     generator=torch.Generator().manual_seed(3))
loss = Reference(m).loss(leaf_views(p, leaves), toks[:, :-1], toks[:, 1:])
loss.backward()
w_out = next(lf for lf in leaves if lf.name.endswith("ffn.w_out"))
print(json.dumps({
    "kinds": kinds, "names": [lf.name for lf in leaves],
    "param_count": shapes.param_count(m), "loss": loss.item(),
    "grad_norm": float(p.grad.norm()),
    "w_out_std": float(p[w_out.offset:w_out.offset + w_out.numel].std()),
    "loaded": sorted({k.split(".")[0] for k in sys.modules})}))
'''


def test_a_new_kind_is_one_new_file(tmp_path):
    """A copy of perfbench/ with one file added under layers/ takes a
    configuration of the new kind: it resolves, lays out, draws its
    weights (its own draw too) and runs the reference's loss and
    backward, with no other file touched."""
    copy = tmp_path / "perfbench"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    (copy / "layers" / "toy_gelu.py").write_text(TOY)
    m = {**TINY["attn"], "toy_gelu": True}
    with pytest.raises(ValueError):         # here, no kind reads toy_gelu
        shapes.slots(m)
    out = subprocess.run([sys.executable, "-c", DRIVE, str(copy),
                          json.dumps(m)], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.splitlines()[-1])
    assert got["kinds"] == [["attention", "toy_gelu"]]
    assert "slots.0.ffn.w_in" in got["names"]
    assert "slots.0.ffn.w1" not in got["names"]
    d, ff, V = 64, 128, 256
    assert got["param_count"] == 2 * V * d + 2 * (
        shapes.slots(TINY["attn"])[0].mixer.active(m, 0) + 2 * d * ff)
    assert got["w_out_std"] == pytest.approx(0.5 * ff ** -0.5, rel=0.05)
    assert 0 < got["loss"] < 10 and 0 < got["grad_norm"] < float("inf")
    assert not set(got["loaded"]) & {"repro_torch", "repro", "jax"}

"""Tensor parallelism: the port's model ranks against the reference's
``jax.shard_map`` over a (1, tp) mesh of host CPU devices.

Two reference children (``tests/torch_tp_reference.py``, with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``) write the
reference's weights (its own ``Model(cfg, tp).init``; Mamba's conv and the
cross gate, zero at init, drawn), its loss, and each rank's gradient and
parameters raveled inside ``shard_map`` (the flats a rank sees), and the
outputs and input gradients of the primitives.  Then four gloo ranks
(``tests/torch_tp_worker.py``) run the port: a tp = 2 case on one pair of
ranks, a tp = 4 case on all four, each rank with the weights
``weights.from_jax_params(tree, cfg, tp, rank)`` gives.

The cases: (a) the primitives at tp = 2 and 4 (the vocabulary-sharded
embedding, the chunked loss and serving's all-gathered logits over
granite's vocabulary of 509, padded, the SwiGLU FFN, attention with
padded heads); (b) the loss and every
rank's gradient of one SMOKE config of each family at tp = 2 (dense,
MoE, the shared expert, RWKV6, the Mamba hybrid, the VLM with image
embeddings, granite's padded vocabulary; llama4's, jamba's and the VLM's
layer pattern cut to one group of two layers, which still holds each of
their slot kinds, to save the reference's compile), MoE at ep x fp = 2 x 2 (two
experts at tp = 4) and qwen1.5's qkv bias with 6 heads padded to 8 at
tp = 4; (f) the reference's quirk, pinned on a float32 dense model whose
tp = 2 weights are its tp = 1 weights cut in two: the loss at tp = 2 is
the tp = 1 loss, every sharded leaf's gradient is twice the tp = 1
gradient, and a replicated leaf's gradients summed over the ranks are
twice the tp = 1 gradient (each rank's is its own partial).

The port's own init at tp draws the replicated leaves alike on every
rank of the model group and the sharded ones per rank.

Tolerances, float32 compute throughout: the loss rtol 1e-6; gradients
and outputs within 1e-5 of each leaf's (output's) largest entry (the
packages sum matmuls in other orders).
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
import torch_tp_worker as worker

from repro_torch import weights
from repro_torch.models import make_dims
from repro_torch.models.transformer import (
    REPLICATED_LEAVES, Model, param_layout)

# one thread: xdist workers that each take every core starve one another
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 600
LLAMA = "llama3.2-1b"
# the quirk's config: float32, 2 layers, d 64, 4 q / 2 kv heads
QUIRK = {"d_model": 64, "num_heads": 4, "num_kv_heads": 2, "head_dim": 16,
         "d_ff": 128, "vocab_size": 256}
MODEL_CASES = [
    {"name": "dense", "arch": "qwen3-0.6b", "tp": 2, "pair": 0},
    {"name": "moe", "arch": "mixtral-8x7b", "tp": 2, "pair": 1},
    {"name": "moe_ep2_fp2", "arch": "mixtral-8x7b",
     "over": {"num_experts": 2}, "tp": 4},
    {"name": "shared_expert", "arch": "llama4-scout-17b-a16e",
     "over": {"full_attn_every": 2, "num_layers": 2}, "tp": 2, "pair": 0},
    {"name": "rwkv6", "arch": "rwkv6-7b", "tp": 2, "pair": 1},
    {"name": "hybrid", "arch": "jamba-1.5-large-398b",
     "over": {"attn_every": 2, "num_layers": 2}, "tp": 2, "pair": 0},
    {"name": "vlm", "arch": "llama-3.2-vision-11b",
     "over": {"cross_attn_every": 2, "num_layers": 2}, "tp": 2, "pair": 1},
    {"name": "granite", "arch": "granite-3-2b", "tp": 2, "pair": 0},
    {"name": "padded_heads", "arch": "qwen1.5-32b",
     "over": {"num_heads": 6, "num_kv_heads": 2, "head_dim": 32}, "tp": 4},
    {"name": "quirk", "arch": LLAMA, "over": QUIRK, "tp": 2, "pair": 1,
     "split": True},
]
PRIM_CASES = [
    {"name": f"{prim}_tp{tp}", "arch": arch, "prim": prim, "tp": tp,
     "pair": i % 2, "S": S, "over": over}
    for tp in (2, 4)
    for i, (prim, arch, S, over) in enumerate((
        ("embed", "granite-3-2b", 32, {}),
        ("loss", "granite-3-2b", 1024, {}),
        ("logits", "granite-3-2b", 32, {}),
        ("ffn", "qwen3-0.6b", 32, {}),
        ("attn", "qwen1.5-32b", 32, {"num_heads": 6, "num_kv_heads": 2,
                                      "head_dim": 32})))]


def _reference(mode, out, cases):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests",
                                      "torch_tp_reference.py"),
         mode, str(out), json.dumps(cases)], env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _wait(child):
    out, err = child.communicate(timeout=DEADLINE_S)
    assert child.returncode == 0 and "REFERENCE_OK" in out, err[-4000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("tp")
    # three children share the model cases (each compiles its own)
    parts = [base / f"model{i}.npz" for i in range(3)]
    children = [_reference("model", out, MODEL_CASES[i::3])
                for i, out in enumerate(parts)]
    children.append(_reference("prims", base / "prims.npz", PRIM_CASES))
    for c in children:
        _wait(c)
    z = {}
    for out in parts:
        z.update(np.load(out))
    np.savez(base / "model.npz", **z)
    torch.save({"model": MODEL_CASES, "prims": PRIM_CASES}, base / "job.pt")
    ctx = mp.start_processes(worker.spawn_model, args=(4, str(base)),
                             nprocs=4, join=False, start_method="spawn")
    t0 = time.monotonic()
    while not ctx.join(timeout=5):
        if time.monotonic() - t0 > DEADLINE_S:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the spawned ranks did not finish")
    ranks = [torch.load(base / f"rank{r}.pt") for r in range(4)]
    return {"model": np.load(base / "model.npz"),
            "prims": np.load(base / "prims.npz"), "ranks": ranks}


def _ranks_of(case):
    """(global rank, model rank) of the ranks that ran ``case``."""
    if case["tp"] == 4:
        return [(r, r) for r in range(4)]
    first = 2 * case["pair"]
    return [(first + m, m) for m in range(2)]


def _close(got, want, what, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= rel * scale, (what, err, scale)


def _leaves(cfg, tp):
    """(name, slice) of every leaf of one rank's flat."""
    out, off = [], 0
    for name, shape, _ in param_layout(cfg, tp):
        n = int(np.prod(shape))
        out.append((name, slice(off, off + n)))
        off += n
    return out


@pytest.mark.parametrize("case", MODEL_CASES, ids=lambda c: c["name"])
def test_loss_and_every_rank_gradient_match_the_reference(runs, case):
    z, name, tp = runs["model"], case["name"], case["tp"]
    cfg = worker.config(case)
    for r, m in _ranks_of(case):
        got = runs["ranks"][r][name]
        # the layout: the rank's flat is the reference's ravel inside
        # shard_map, and from_jax_params cuts it from the global tree
        np.testing.assert_array_equal(got["flat"].numpy(),
                                      z[f"{name}.flat"][m])
        np.testing.assert_allclose(got["loss"].item(), z[f"{name}.loss"][m],
                                   rtol=1e-6)
        want = z[f"{name}.grad"][m]
        for leaf, sl in _leaves(cfg, tp):
            _close(got["grad"][sl].numpy(), want[sl], f"{name}:{m}:{leaf}")


@pytest.mark.parametrize("case", MODEL_CASES[:6], ids=lambda c: c["name"])
def test_init_draws_replicated_leaves_alike_on_every_rank(runs, case):
    """The port's own init at tp: the reference's replicated leaves (kv
    projections, the router, RWKV6's decay LoRA and mixes) are the same
    on every rank of the model group, every sharded matrix differs."""
    cfg = worker.config(case)
    inits = [runs["ranks"][r][case["name"]]["init"]
             for r, _ in _ranks_of(case)]
    drawn = 0
    for leaf, sl in _leaves(cfg, case["tp"]):
        same = all(torch.equal(x[sl], inits[0][sl]) for x in inits)
        if leaf.rsplit(".", 1)[-1] in REPLICATED_LEAVES:
            assert same, leaf
            drawn += 1
        elif leaf.endswith((".wq", ".w1", ".in_proj", ".proj_r")):
            assert not same, leaf
    assert drawn


def test_every_model_rank_holds_its_own_gradient_of_the_replicated_leaves(
        runs):
    """The kv projections and the norms train on each rank's partial
    gradient, which differ across the model group (in both packages)."""
    case = MODEL_CASES[0]
    cfg, name = worker.config(case), case["name"]
    grads = [runs["ranks"][r][name]["grad"] for r, _ in _ranks_of(case)]
    for leaf, sl in _leaves(cfg, 2):
        if leaf.endswith((".wk", ".wv", ".norm1", "final_norm")):
            assert not torch.equal(grads[0][sl], grads[1][sl]), leaf


def test_the_quirk_sharded_gradients_are_tp_times_and_the_loss_is_tp1s(
        runs):
    """The reference's tp = 2 run of weights cut from a tp = 1 run: the
    loss is bit-equal to tp = 1's; a sharded leaf's gradient is 2x the
    tp = 1 gradient; a replicated leaf's gradients summed over the two
    ranks are 2x it.  The port's tp = 2 ranks hold the same relations,
    and its tp = 1 model the tp = 1 side."""
    z, case = runs["model"], MODEL_CASES[-1]
    cfg, name = worker.config(case), case["name"]
    tp1 = z[f"{name}.tp1_grad"][0]
    assert z[f"{name}.loss"][0] == z[f"{name}.loss"][1] == \
        z[f"{name}.tp1_loss"][0]
    # the port at tp = 1 on the same weights
    port1 = Model(cfg, device="cpu")
    port1.load_flat(weights.from_jax_params(worker.tree_of(z, f"{name}.w1"),
                                            cfg))
    row = torch.zeros_like(port1.flat)
    port1.attach_grads(row)
    ids = torch.from_numpy(z[f"{name}.batch.ids"]).long()
    labels = torch.from_numpy(z[f"{name}.batch.labels"]).long()
    loss1 = port1.loss(ids, labels)
    loss1.backward()
    np.testing.assert_allclose(loss1.item(), z[f"{name}.tp1_loss"][0],
                               rtol=1e-6)
    _close(row.numpy(), tp1, "tp=1 gradient")
    port2 = [runs["ranks"][r][name] for r, _ in _ranks_of(case)]
    for p in port2:
        np.testing.assert_allclose(p["loss"].item(), loss1.item(), rtol=1e-6)
    layout1 = dict(_leaves(cfg, 1))
    for leaf, sl in _leaves(cfg, 2):
        ref2 = [z[f"{name}.grad"][m][sl] for m in range(2)]
        port = [p["grad"][sl].numpy() for p in port2]
        want1 = tp1[layout1[leaf]]
        if leaf.endswith((".wq", ".wo", ".w1", ".w2", ".w3", "embed",
                          "lm_head")):
            for m in range(2):
                w = 2 * _shard(want1, leaf, cfg, m)
                _close(ref2[m], w, f"reference {leaf}:{m}")
                _close(port[m], w, f"port {leaf}:{m}")
        else:
            _close(ref2[0] + ref2[1], 2 * want1, f"reference {leaf}")
            _close(port[0] + port[1], 2 * want1, f"port {leaf}")


def _shard(flat1, leaf, cfg, m):
    """Model rank m's half of a sharded leaf of the tp = 1 flat."""
    shape1 = dict((n, s) for n, s, _ in param_layout(cfg, 1))[leaf]
    a = flat1.reshape(shape1)
    if leaf in ("embed", "lm_head"):
        ax = 1 if leaf == "embed" else 2
    else:
        ax = 3 if leaf.endswith((".wq", ".w1", ".w3")) else 2
    return np.split(a, 2, axis=ax)[m].reshape(-1)


@pytest.mark.parametrize("case", PRIM_CASES, ids=lambda c: c["name"])
def test_primitives_match_the_reference(runs, case):
    z, name = runs["prims"], case["name"]
    for r, m in _ranks_of(case):
        got = runs["ranks"][r][name]
        _close(got["out"].numpy(), z[f"{name}.out"][m], f"{name}:{m}:out")
        for k, g in got["grad"].items():
            want = z[f"{name}.grad.{k}"][m]
            if k != "x":
                want = want[0]
            _close(g.numpy(), want, f"{name}:{m}:d{k}")


def test_padding_gets_no_gradient(runs):
    """granite's vocabulary of 509 pads to 510 at tp = 2: model rank 1's
    last lm_head column gets no gradient.  Six q heads pad to eight at
    tp = 4: model rank 3 holds two padding heads, whose wq columns and
    wo rows get none (their output is masked)."""
    case = next(c for c in MODEL_CASES if c["name"] == "granite")
    cfg = worker.config(case)
    assert make_dims(cfg, 2).vocab_local == 255
    sl = dict(_leaves(cfg, 2))["lm_head"]
    g = runs["ranks"][_ranks_of(case)[1][0]]["granite"]["grad"][sl]
    g = g.view(cfg.d_model, 255)
    assert torch.all(g[:, -1] == 0) and torch.any(g[:, :-1] != 0)
    case = next(c for c in MODEL_CASES if c["name"] == "padded_heads")
    cfg = worker.config(case)
    assert make_dims(cfg, 4).heads_local == 2
    leaves = dict(_leaves(cfg, 4))
    for r in range(4):
        g = runs["ranks"][r]["padded_heads"]["grad"]
        for leaf in ("slots.0.mixer.wq", "slots.0.mixer.wo",
                     "slots.0.mixer.bq"):
            assert bool(torch.all(g[leaves[leaf]] == 0)) == (r == 3), leaf

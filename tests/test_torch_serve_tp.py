"""Serving at tp > 1: the port's sequence-sharded caches, its distributed
decode softmax and its sharded recurrent states against the reference's
``jax.shard_map``-ped prefill and decode, and ``--tp`` in the serve
launcher.

One reference child (``tests/torch_tp_reference.py serve``, on 4 host
CPU devices) runs each case's ``Model.prefill`` and 3 teacher-forced
``Model.decode`` steps over a (dp, tp) mesh, one jitted program each, and
writes the weights (its own ``Model(cfg, tp).init``; Mamba's conv, the
cross gate and RWKV6's decay path drawn), the logits and the global
caches (its out-specs ``cache_pspecs`` put the ranks' shards together).
Then four gloo ranks (``tests/torch_tp_worker.py``) run the port from
``weights.from_jax_params(tree, cfg, tp, rank)``: a tp = 2 case on one
pair of ranks, a tp = 4 case and the (2, 2) grid on all four.  Each rank
prefills, gathers its caches (``Model.gather_caches``), and decodes 3
steps from its cut of the reference's prefill caches
(``weights.from_jax_caches(..., tp, rank, cache_shards, shard_id)``).

The cases: dense FULL attention at an odd ``max_len`` of 19, whose ring
rounds up to 20 slots; a sliding window of 8 and chunks of 8 under
prompts of 12, so that the ring wraps across the shard boundary (tp = 2
and 4); qwen1.5's qkv bias with 6 heads padded to 8 at tp = 4; RWKV6, the
Mamba hybrid with MoE and the VLM with image embeddings at tp = 2; and
the batch-1 long-context layout, ``seq_shard_axes=("data", "model")`` on
the (2, 2) grid with 4 cache shards (the counterpart of
``tests/test_seqsharded_decode.py``).  Beside them: a dense model at
tp = 2 whose weights are its tp = 1 weights cut in two serves the tp = 1
logits, and the launcher under torchrun at ``--tp 2`` on 4 ranks serves
its data ranks' rows as a 2-rank run serves the whole batch, while
``--tp 3`` on 4 ranks raises.

Tolerances (float32, as ``test_torch_serve.py``): logits within 1e-5 of
their largest entry; every rank's cache leaves against its slice of the
reference's within 1e-6 of the slice's largest entry (Mamba's within
1e-5, ``test_torch_serve_recurrent.py``'s band).
"""
import json
import os
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
import torch_tp_worker as worker

from repro.models import Model as JModel
from repro.models import attention as jattn
from repro.models.layers import make_dims as jmake_dims
from repro_torch import weights
from repro_torch.launch import serve
from repro_torch.models.attention import cache_spec
from repro_torch.models.layers import TPCtx
from repro_torch.models.transformer import Model
from test_torch_serve import close

# one thread: xdist workers that each take every core starve one another
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 600
LLAMA = "llama3.2-1b"
STEPS = 3
DENSE = {"batch": 2, "prompt": 16, "max_len": 19}
RING = {"batch": 2, "prompt": 12, "max_len": 16}
# the SMOKE configs at test_torch_serve.py's width, where float32's
# rounding of the projections stays inside the caches' band of 1e-6
NARROW = {"d_model": 64, "d_ff": 128, "vocab_size": 256}
HEADS = {"num_heads": 4, "num_kv_heads": 2, "head_dim": 16}


def _case(name, arch, tp, shards, shape, **over):
    return {"name": name, "arch": arch, "tp": tp, "shards": shards,
            "over": {**NARROW, **HEADS, **over}, **shape}


CASES = [
    {**_case("dense_odd", LLAMA, 2, 2, DENSE), "pair": 0},
    {**_case("sliding", LLAMA, 2, 2, RING, attn_kind="sliding", window=8),
     "pair": 1},
    _case("chunked", LLAMA, 4, 4, RING, attn_kind="chunked", chunk=8),
    _case("padded_heads", "qwen1.5-32b", 4, 4, DENSE, num_heads=6),
    {**_case("rwkv6", "rwkv6-7b", 2, 2, DENSE, rwkv_head_dim=16),
     "pair": 0},
    {**_case("hybrid", "jamba-1.5-large-398b", 2, 2, DENSE, attn_every=2,
             num_layers=2), "pair": 1},
    {**_case("vlm", "llama-3.2-vision-11b", 2, 2, DENSE, cross_attn_every=2,
             num_layers=2), "pair": 0},
    {**_case("long_context", LLAMA, 2, 4, {**DENSE, "batch": 1}),
     "dp": 2, "seq": ["data", "model"]},
]
SPLIT = {**_case("split", LLAMA, 2, 2, DENSE), "pair": 1, "split": True}
SERVE = ["--device", "cpu", "--backend", "gloo", "--batch", "4",
         "--prompt-len", "8", "--gen", "4"]
LOGIT_TOL = 1e-5


def _cache_tol(cfg, slot):
    return 1e-5 if cfg.slot_kind(slot) == "mamba" else 1e-6


def _env(**extra):
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]), **extra)


def _torchrun(nproc, args, cwd):
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), *args], cwd=cwd, env=_env(),
        text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _finish(proc):
    try:
        out, err = proc.communicate(timeout=DEADLINE_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    return proc.returncode, out, err


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("serve_tp")
    ref = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_tp_reference.py"),
         "serve", str(base / "serve.npz"), json.dumps(CASES + [SPLIT])],
        env=_env(JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    launches = {}
    for name, nproc, tp in (("four", 4, "2"), ("two", 2, "2")):
        (base / name).mkdir()
        launches[name] = _torchrun(nproc, [
            os.path.join(ROOT, "tests", "torch_tp_worker.py"), "serve",
            str(base / name), *SERVE, "--tp", tp], base)
    launches["tp3"] = _torchrun(4, ["-m", "repro_torch.launch.serve",
                                    *SERVE, "--tp", "3"], base)
    out, err = ref.communicate(timeout=DEADLINE_S)
    assert ref.returncode == 0 and "REFERENCE_OK" in out, err[-4000:]
    torch.save({"serve": CASES + [SPLIT]}, base / "job.pt")
    ctx = mp.start_processes(worker.spawn_serve, args=(4, str(base)),
                             nprocs=4, join=False, start_method="spawn")
    t0 = time.monotonic()
    while not ctx.join(timeout=5):
        if time.monotonic() - t0 > DEADLINE_S:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the spawned ranks did not finish")
    done = {k: _finish(p) for k, p in launches.items()}
    launched = {k: [torch.load(f) for f in sorted((base / k).glob("rank*"))]
                for k in ("four", "two")}
    return {"z": np.load(base / "serve.npz"),
            "ranks": [torch.load(base / f"rank{r}.pt") for r in range(4)],
            "done": done, "launched": launched}


def _ranks_of(case):
    """(global rank, model rank) of the ranks that ran ``case``."""
    if case["tp"] == 4 or case.get("dp", 1) > 1:
        return [(r, r % case["tp"]) for r in range(4)]
    first = 2 * case["pair"]
    return [(first + m, m) for m in range(2)]


def _global(z, name, t, cfg):
    return [(z[f"{name}.c{t}.{s}.0"], z[f"{name}.c{t}.{s}.1"])
            for s in range(cfg.group_size)]


def _check_rank_caches(got, z, name, t, case, cfg, m, shard, what):
    """A rank's caches against its cut of the reference's global ones."""
    want = weights.from_jax_caches(_global(z, name, t, cfg), cfg,
                                   case["tp"], m, case["shards"], shard)
    assert len(got) == len(want), what
    for slot, (g, w) in enumerate(zip(got, want)):
        for i in range(2):
            assert g[i].shape == w[i].shape, (what, slot, i)
            close(g[i], w[i].float().numpy(), _cache_tol(cfg, slot),
                  f"{what} slot {slot} leaf {i}")


@pytest.mark.parametrize("kind", ["full", "sliding", "chunked"])
def test_cache_spec_rounds_the_ring_up_to_the_shards(kind):
    """(C, C_local) as the reference's ``cache_spec``: the ring rounded up
    to a multiple of the shards (19 -> 20 at 2 and 4 shards)."""
    cfg = worker.config({"arch": LLAMA, "over": {
        "attn_kind": kind, "window": 8, "chunk": 6}})
    for max_len in (5, 16, 19):
        for shards in (1, 2, 4):
            want = jattn.cache_spec(cfg, jmake_dims(cfg, 1), kind, max_len,
                                    shards)
            assert cache_spec(cfg, kind, max_len, shards) == want
    if kind == "full":
        assert cache_spec(cfg, kind, 19, 2) == (20, 10)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_cache_shapes_and_layout_match_the_reference(case):
    """``init_cache`` at ``cache_shards`` gives a rank's shapes,
    ``global_cache_shapes`` the reference's ``global_cache_struct`` and
    ``cache_layout`` its ``cache_pspecs``, for the batch split over the
    data axes and not."""
    cfg, tp, dp = worker.config(case), case["tp"], case.get("dp", 1)
    seq = tuple(case.get("seq", ("model",)))
    jm = JModel(cfg, tp=tp, dp=dp, data_axes=("data",), seq_shard_axes=seq)
    model = Model(cfg, device="cpu", tp_ctx=TPCtx(tp, tp - 1, ""),
                  seq_shard_axes=seq)
    B, L, n = case["batch"], case["max_len"], case["shards"]
    want = jm.global_cache_struct(B, L, n, dtype=jnp.float32)
    got = model.global_cache_shapes(B, L, n)
    local = model.init_cache(B, L, cache_shards=n)
    for slot, (g, w, loc) in enumerate(zip(got, want, local)):
        assert [shape for shape, _ in g] == [tuple(x.shape) for x in w]
        for (shape, _), x, spec in zip(g, loc, model.cache_layout()[slot]):
            split = [np.prod([{"model": tp, "data": dp}[a] for a in axes])
                     if axes else 1 for axes in spec]
            split += [1] * (len(shape) - len(split))
            assert tuple(x.shape) == tuple(
                s // k for s, k in zip(shape, split))
    for batch_axes in ((), ("data",)):
        specs = jm.cache_pspecs(batch_axes)
        for mine, theirs in zip(model.cache_layout(batch_axes), specs):
            assert [tuple(s) for s in mine] == [
                tuple(None if a is None else (a,) if isinstance(a, str)
                      else tuple(a) for a in p) for p in theirs]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_prefill_matches_reference(runs, case):
    """Logits, each rank's caches against its slice of the reference's,
    and the caches gathered on every rank against the reference's
    global ones, which ``shard_caches`` cuts back to the rank's."""
    z, name, cfg = runs["z"], case["name"], worker.config(case)
    for r, m in _ranks_of(case):
        got = runs["ranks"][r][name]
        n, shard = got["shard"]
        assert n == case["shards"] and shard == (
            r if case.get("dp", 1) > 1 else m), (name, r)
        close(got["prefill"]["logits"], z[f"{name}.logits0"], LOGIT_TOL,
              f"{name} rank {r} prefill logits")
        _check_rank_caches(got["prefill"]["caches"], z, name, 0, case, cfg,
                           m, shard, f"{name} rank {r} prefill")
        assert got["round_trip"], (name, r)
        for slot, (g, w) in enumerate(zip(got["gathered"],
                                          _global(z, name, 0, cfg))):
            for i in range(2):
                close(g[i], w[i], _cache_tol(cfg, slot),
                      f"{name} rank {r} gathered slot {slot} leaf {i}")


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_decode_from_reference_caches_matches_reference(runs, case):
    """3 teacher-forced steps from each rank's cut of the reference's
    prefill caches: the logits and each rank's caches after every step."""
    z, name, cfg = runs["z"], case["name"], worker.config(case)
    for r, m in _ranks_of(case):
        got = runs["ranks"][r][name]
        for t, step in enumerate(got["steps"], start=1):
            close(step["logits"], z[f"{name}.logits{t}"], LOGIT_TOL,
                  f"{name} rank {r} step {t} logits")
            _check_rank_caches(step["caches"], z, name, t, case, cfg, m,
                               got["shard"][1], f"{name} rank {r} step {t}")


def test_tp2_on_cut_weights_serves_the_tp1_logits(runs):
    """A dense model whose tp = 2 weights are its tp = 1 weights cut in
    two: its prefill and 3 decode steps from its own caches give the
    tp = 1 model's logits, on both ranks."""
    z, case = runs["z"], SPLIT
    cfg, S = worker.config(case), case["prompt"]
    one = Model(cfg, device="cpu")
    one.load_flat(weights.from_jax_params(worker.tree_of(z, "split.w1"),
                                          cfg))
    ids = torch.from_numpy(z["split.ids"]).long()
    logits, caches = one.prefill(ids[:, :S], max_len=case["max_len"])
    want = [logits]
    for i in range(STEPS):
        pos = torch.full((ids.shape[0],), S + i, dtype=torch.int32)
        logits, caches = one.decode(ids[:, S + i], pos, caches)
        want.append(logits)
    for r, _ in _ranks_of(case):
        got = runs["ranks"][r]["split"]
        steps = [got["prefill"]["logits"]] + [s["logits"]
                                              for s in got["steps"]]
        for t, (g, w) in enumerate(zip(steps, want)):
            close(g, w.numpy(), LOGIT_TOL, f"rank {r} step {t}")


def test_launcher_data_ranks_serve_the_whole_batch_of_a_two_rank_run(runs):
    """``--tp 2`` under 4 gloo ranks: each data rank serves its 2 of the 4
    rows, both model ranks of a data rank the same tokens, and together
    the rows of ``--tp 2`` under 2 ranks, which serve the whole batch; a
    second run in the same processes keeps their group and serves the
    same tokens."""
    for k in ("four", "two"):
        rc, out, err = runs["done"][k]
        assert rc == 0, err[-4000:]
    four, two = runs["launched"]["four"], runs["launched"]["two"]
    assert [r["rows"] for r in four] == [[0, 1], [0, 1], [2, 3], [2, 3]]
    assert [r["rows"] for r in two] == [[0, 1, 2, 3]] * 2
    whole = two[0]["tokens"]
    assert whole.shape == (4, 4) and torch.equal(two[1]["tokens"], whole)
    for r in four:
        assert torch.equal(r["tokens"], whole[r["rows"]]), r["rows"]
    for r in four + two:
        assert torch.equal(r["again"], r["tokens"])


def test_launcher_refuses_a_tp_that_does_not_divide_the_world(runs):
    rc, out, err = runs["done"]["tp3"]
    assert rc != 0 and "tp=3 does not divide the world of 4 ranks" in err


def test_launcher_refuses_tp_without_a_group():
    with pytest.raises(ValueError, match="--tp needs a process group"):
        serve.run(serve.parse_args(["--device", "cpu", "--tp", "2"]))

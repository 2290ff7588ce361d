"""The port's FSDP substrate (``repro_torch.dist.fsdp``) against the
reference's ``repro.dist.fsdp``.

The layout functions (``flatten_meta``, ``flat_size``, ``chunk_plan``,
``padded_flat_len``, ``unflatten``, ``_rounds_for``) and the model's FSDP
layout (every slot's meta and padded length, embed's and lm_head's) are
held exact.  ``_quantized_reduce_scatter`` is held against the
reference's under ``jax.vmap(axis_name="data")`` (one vmapped program a
case) at M = 2 and 4 with the uniform, entropy-coded and mixed-width
codecs, with and without the error-feedback residual: both sides get the
same numpy cotangents, and the port replays the reference's keys
(``fold(rank)``, then ``fold(round)``) through ``JaxKey``.  Every round's
payload words must equal the reference's (its codec wrapped to record
them; a uniform code may be one off only where the reference's |u - rho|
< 1e-5); the shard means and new residuals within 1e-6 of the
terms' magnitude (decoded terms carry their norm's last ulp; the mean
adds in another order).  The float32 reduce-scatter mean is held against
``psum_scatter / M`` at rtol 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import codec as jcodec
from repro.core.schemes import QuantScheme as JScheme
from repro.dist import fsdp as jfsdp
from repro.models import Model as JModel
from repro.models.transformer import slot_param_specs
from repro_torch import configs
from repro_torch.core import codec, packing
from repro_torch.core.schemes import QuantScheme
from repro_torch.dist import fsdp
from repro_torch.dist.transport import StackedTransport
from repro_torch.kernels import ref
from repro_torch.models.transformer import fsdp_layout, slot_meta

# one thread: xdist workers that each take every core starve one another
torch.set_num_threads(1)

BS = 128
KEY = jax.random.PRNGKey(21)
ARCHS = ("qwen3-0.6b", "jamba-1.5-large-398b", "llama-3.2-vision-11b",
         "mixtral-8x7b", "rwkv6-7b")


class JaxKey:
    """A port key that replays ``jax.random``: fold is ``fold_in``,
    uniform the reference codec's draw."""

    def __init__(self, key):
        self.key = key

    def fold(self, i):
        return JaxKey(jax.random.fold_in(self.key, i))

    def uniform(self, shape, device):
        return torch.from_numpy(np.array(jax.random.uniform(
            self.key, shape, jnp.float32))).to(device)


@pytest.mark.parametrize("arch", ARCHS)
def test_flatten_meta_and_model_layout_match_reference(arch):
    jcfg, cfg = jconfigs.get_smoke_config(arch), configs.get_smoke_config(arch)
    M = 4
    jm = JModel(jcfg, tp=1, dp=M, param_mode="fsdp",
                fsdp_scheme=JScheme(bucket_size=BS))
    entries = fsdp_layout(cfg, BS, M)
    for s in range(cfg.group_size):
        specs = slot_param_specs(jcfg, jm.dims, 1, s)
        want = jfsdp.flatten_meta(specs)
        assert fsdp.flatten_meta(specs) == want
        assert slot_meta(cfg, s) == want
        assert fsdp.flat_size(want) == jfsdp.flat_size(want)
        assert entries[3 + s].meta == want
        assert entries[3 + s].Lp == jm._slot_len[s]
        assert entries[3 + s].count == cfg.num_groups
    assert (entries[0].meta, entries[0].Lp) == (jm._embed_meta, jm._embed_len)
    assert (entries[2].meta, entries[2].Lp) == (jm._lm_meta, jm._lm_len)
    assert entries[1].Lp == cfg.d_model
    # the reference's FSDP tree, in ravel order
    struct = jm.param_struct()
    assert [e.name for e in entries] == (
        ["embed", "final_norm", "lm_head"]
        + [f"slots.{s}" for s in range(len(struct["slots"]))])
    assert struct["embed"].shape == (1, entries[0].Lp)
    for s, leaf in enumerate(struct["slots"]):
        assert leaf.shape == (cfg.num_groups, 1, entries[3 + s].Lp)


def test_chunk_plan_padded_len_and_rounds_match_reference():
    for n in (1, 127, 128, 129, 1000, 4096, 33_000, 262_145):
        for bs in (64, 128, 8192):
            for M in (1, 2, 3, 4, 8):
                assert fsdp.chunk_plan(n, bs, M) == jfsdp.chunk_plan(n, bs, M)
                meta = [(("w",), (n,), 1)]
                for shards in (None, 2, M):
                    assert (fsdp.padded_flat_len(meta, bs, M, shards)
                            == jfsdp.padded_flat_len(meta, bs, M, shards))
    for nb in range(0, 200):
        assert fsdp._rounds_for(nb) == jfsdp._rounds_for(nb)


def test_unflatten_matches_reference():
    cfg = jconfigs.get_smoke_config("jamba-1.5-large-398b")
    jm = JModel(cfg, tp=1, dp=2, param_mode="fsdp",
                fsdp_scheme=JScheme(bucket_size=BS))
    meta = jm._slot_meta[1]
    n = jm._slot_len[1]
    flat = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    want = jax.tree_util.tree_flatten_with_path(
        jfsdp.unflatten(jnp.asarray(flat), meta, jnp.float32))[0]
    got = fsdp.unflatten(torch.from_numpy(flat), meta, torch.float32)
    assert len(want) == len(meta)
    for (path, leaf), (mpath, _, _) in zip(want, meta):
        node = got
        for p in mpath:
            node = node[p]
        assert tuple(k.key for k in path) == mpath
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


# ---------------------------------------------------------------------------
# the quantized reduce-scatter
# ---------------------------------------------------------------------------

class Recording:
    """A codec that keeps every payload's words it encodes."""

    def __init__(self, inner):
        self.inner, self.words = inner, []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def encode(self, *args, **kwargs):
        p = self.inner.encode(*args, **kwargs)
        self.words.append(p.words)
        return p


def _codecs(kind):
    kw = dict(name="alq", bits=3, bucket_size=BS)
    return (jcodec.make_codec(JScheme(**kw), kind),
            codec.make_codec(QuantScheme(**kw), kind), JScheme(**kw))


def _rows(M, nb, seed):
    rng = np.random.default_rng(seed)
    scale = np.exp(rng.standard_normal((M, 1)))
    rows = (rng.standard_normal((M, nb * BS)) * 1e-2 * scale)
    res = rng.standard_normal((M, nb * BS)) * 1e-3
    return rows.astype(np.float32), res.astype(np.float32)


def _reference(jc, jscheme, rows, residual):
    """The reference's reduce-scatter under a vmapped data axis, with
    every round's payload words of every worker (its codec wrapped in a
    ``Recording``): one compiled program."""
    levels = jscheme.init_levels()
    M, Lp = rows.shape
    shard_nb = Lp // BS // M
    k = jfsdp._rounds_for(shard_nb) if jc.chunkable else 1
    plan = jc.plan_buckets(M * (shard_nb // k), shards=M)

    def worker(g, r):
        rec = Recording(jc)
        out = jfsdp._quantized_reduce_scatter(
            g, levels, KEY, axes=("data",), codec=rec, use_pallas=False,
            residual=None if residual is None else r)
        return out, rec.words

    r = np.zeros_like(rows) if residual is None else residual
    out, words = jax.jit(jax.vmap(worker, axis_name="data"))(rows, r)
    # words[c][w]: worker w's round-c payload
    return out, [[words[c][w] for c in range(k)] for w in range(M)], k, plan


def _assert_words(got, want, kind, plan, vb, u, levels):
    """Words exact; a uniform code may be one off where the reference's
    |u - rho| < 1e-5 (judged under the port's norms of the same slice)."""
    want = torch.from_numpy(np.array(want).view(np.int32))
    if torch.equal(got, want):
        return
    assert kind == "uniform", "entropy/mixed words differ"
    L = levels.shape[0]
    n = plan.shard_n
    wb = packing.wire_bits_for(L)
    got_c = torch.cat([packing.unpack(w, n, wb) for w in got]) - (L - 1)
    want_c = torch.cat([packing.unpack(w, n, wb) for w in want]) - (L - 1)
    _, norms = ref.quantize_ref(vb, u, levels, "l2")
    ref.code_mismatches(got_c.view(vb.shape), want_c.view(vb.shape), vb, u,
                        norms, levels)


@pytest.mark.parametrize("M,nb", [(2, 8), (4, 16)])
@pytest.mark.parametrize("kind", ["uniform", "entropy", "mixed_width"])
@pytest.mark.parametrize("ef", [False, True])
def test_quantized_reduce_scatter_matches_reference(M, nb, kind, ef):
    jc, tc, jscheme = _codecs(kind)
    _, nb = fsdp.chunk_plan(nb * BS, BS, M)
    rows, residual = _rows(M, nb, seed=M + 10 * ef)
    residual = residual if ef else None
    jout, jwords, k, plan = _reference(jc, jscheme, rows, residual)
    rec = Recording(tc)
    levels = QuantScheme(name="alq", bits=3, bucket_size=BS).init_levels(
        "cpu")
    out = fsdp._quantized_reduce_scatter(
        torch.from_numpy(rows), levels, [JaxKey(KEY)] * M,
        transport=StackedTransport(M), codec=rec,
        residual=None if residual is None else torch.from_numpy(residual))
    # the port encodes round by round, the workers within a round
    inp = rows if residual is None else rows + residual
    shard_nb, ppr = nb // M, nb // M // k
    for w in range(M):
        kw = JaxKey(KEY).fold(w)
        gb = torch.from_numpy(inp[w]).view(M, shard_nb, BS)
        for c in range(k):
            vb = gb[:, c * ppr:(c + 1) * ppr].reshape(M * ppr, BS)
            u = kw.fold(c).uniform(vb.shape, "cpu")
            _assert_words(rec.words[c * M + w], jwords[w][c], kind,
                          plan, vb, u, levels)
    jmean = np.asarray(jout[0] if ef else jout)
    mean = out[0] if ef else out
    assert mean.shape == (M, nb * BS // M)
    scale = np.abs(rows).max() + (0 if residual is None else
                                  np.abs(residual).max())
    np.testing.assert_allclose(mean.numpy(), jmean, rtol=0,
                               atol=1e-6 * scale)
    if ef:
        np.testing.assert_allclose(out[1].numpy(), np.asarray(jout[1]),
                                   rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("M", [2, 4])
def test_fp32_reduce_scatter_mean_matches_psum_scatter(M):
    rows, _ = _rows(M, 8 * M, seed=5)

    def worker(g):
        return jax.lax.psum_scatter(g, "data", scatter_dimension=0,
                                    tiled=True) / M

    want = jax.jit(jax.vmap(worker, axis_name="data"))(rows)
    got = StackedTransport(M).reduce_scatter_mean(torch.from_numpy(rows))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


def test_gather_forms_and_refusals():
    """The stacked gather is the concatenation of the shards; its
    backward leaves the cotangent as the shards' gradient.  The EF gather
    refuses warm-up steps and stacked workers."""
    from repro_torch.compress import make_algorithm
    scheme = QuantScheme(name="alq", bits=3, bucket_size=BS)
    shards = torch.randn((4, 2 * BS)).requires_grad_()
    gather = fsdp.make_gather(scheme, transport=StackedTransport(4))
    full = gather(shards, scheme.init_levels("cpu"), fsdp.SeedKey(0))
    assert torch.equal(full, shards.detach().reshape(-1))
    g = torch.randn(full.shape)
    full.backward(g)
    assert torch.equal(shards.grad, g.view(4, -1))
    with pytest.raises(ValueError, match="warmup_steps"):
        fsdp.make_gather(scheme, algorithm=make_algorithm("ef:3", scheme))
    ef = fsdp.make_gather(scheme, transport=StackedTransport(4),
                          algorithm=make_algorithm("ef", scheme))
    with pytest.raises(NotImplementedError, match="one worker a process"):
        ef(shards, scheme.init_levels("cpu"), fsdp.SeedKey(0),
           torch.zeros(4 * 2 * BS))


def test_one_worker_gather_runs_the_reduce_scatter_in_its_backward():
    """M = 1: the backward is ``_quantized_reduce_scatter`` of the
    cotangent (quantized), or the cotangent itself (float32)."""
    scheme = QuantScheme(name="alq", bits=3, bucket_size=BS)
    levels = scheme.init_levels("cpu")
    g = torch.randn(16 * BS) * 1e-2
    key = fsdp.SeedKey(3)
    want = fsdp._quantized_reduce_scatter(
        g[None], levels, [key], transport=StackedTransport(1),
        codec=codec.codec_for_scheme(scheme))
    for sync, expect in (("quantized", want), ("fp32", g[None])):
        shard = torch.zeros((1, 16 * BS), requires_grad=True)
        out = fsdp.make_gather(scheme, sync)(shard, levels, key)
        out.backward(g)
        assert torch.equal(shard.grad, expect), sync


def test_seed_key_folds_and_draws_deterministically():
    a, b = fsdp.SeedKey(5).fold(1), fsdp.SeedKey(5).fold(1)
    assert a.seed == b.seed != fsdp.SeedKey(5).fold(2).seed
    assert torch.equal(a.uniform((3, 4), "cpu"), b.uniform((3, 4), "cpu"))
    assert not torch.equal(a.uniform((3, 4), "cpu"),
                           a.fold(0).uniform((3, 4), "cpu"))


def test_sparse_codec_reduce_scatter_runs_and_keeps_its_support():
    """The sparse (top-k) codec on the wire: each worker's shard of the
    mean is the mean of the M decoded top-k streams of that shard."""
    from repro_torch.compress import SparseCodec
    M = 2
    sc = SparseCodec(num_levels=8, bucket_size=BS, k=16)
    rows, _ = _rows(M, 16, seed=9)
    levels = QuantScheme(name="alq", bits=3, bucket_size=BS).init_levels(
        "cpu")
    out = fsdp._quantized_reduce_scatter(
        torch.from_numpy(rows), levels, [fsdp.SeedKey(1)] * M,
        transport=StackedTransport(M), codec=sc)
    assert out.shape == (M, 8 * BS)
    assert torch.isfinite(out).all()
    nz = (out.view(-1, BS) != 0).sum(1)
    assert (nz <= M * 16).all() and (nz > 0).all()
    dataclasses.replace(sc)   # a frozen dataclass, as the reference's

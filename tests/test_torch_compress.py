"""The port's compression algorithms (plain, ef, topk) against the
reference package.

Both packages get the same gradients and uniforms (the reference's draws,
fed to the port).  The reference runs ``compressed_allreduce`` under
``jax.vmap`` over M=4 workers with its kernels' plain versions, each
worker's ``CompressState`` stacked along the worker axis.

Tolerances:
  * top-k index words exact, padding and tie-filled buckets included (the
    port's stable sort keeps the lower index first, as ``lax.top_k``);
    value words exact (L-inf: the kept-set norm is a max) and the port's
    decode of the reference's words exact;
  * plans, bits/coord and kept_fraction exact;
  * aggregates within 1e-6 of the terms' scale (norms summed in another
    order differ in the last ulp); residuals likewise, a residual being
    inp - Q(inp) with Q(inp) one of those terms;
  * residual norms rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compress as jcompress
from repro.compress import CompressState as JCompressState
from repro.core.schemes import QuantScheme as JScheme
from repro.dist import sync as jsync
from repro_torch import compress
from repro_torch.core import codec
from repro_torch.core.schemes import QuantScheme
from repro_torch.dist import sync
from repro_torch.train.train_step import TrainConfig, _make_algo

# one thread: xdist workers that each take every core starve one another
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(3)
M, D = 4, 5000


def _grads(M, d, seed=0):
    rng = np.random.default_rng(seed)
    scale = np.exp(rng.standard_normal((M, 1)))
    return (rng.standard_normal((M, d)) * 1e-2 * scale).astype(np.float32)


def _uniforms(key, shape):
    return torch.from_numpy(np.array(
        jax.random.uniform(key, shape, jnp.float32)))


def _tie_buckets(bs, nb):
    """Buckets that exercise the selection's tie rule: all zero, fewer
    nonzeros than k, and many equal magnitudes of both signs."""
    rng = np.random.default_rng(1)
    vb = (rng.standard_normal((nb, bs)) * 1e-2).astype(np.float32)
    vb[1] = 0.0
    vb[2, :] = 0.0
    vb[2, rng.choice(bs, 5, replace=False)] = 0.3
    vb[3] = np.where(rng.random(bs) < 0.5, 0.25, -0.25)
    vb[4, ::3] = 0.125
    return vb


@pytest.mark.parametrize("name,bits,bs,k", [
    ("qsgdinf", 3, 256, 40), ("alq_inf", 2, 512, 100), ("qsgdinf", 8, 128, 1),
    ("qsgdinf", 3, 100, 100)])
def test_topk_words_match_reference(name, bits, bs, k):
    kw = dict(name=name, bits=bits, bucket_size=bs)
    jc = jcompress.sparse_codec_for_scheme(JScheme(**kw), k=k)
    tc = compress.sparse_codec_for_scheme(QuantScheme(**kw), k=k)
    nb = 16
    vb = _tie_buckets(bs, nb)
    jplan, plan = jc.plan_buckets(nb), tc.plan_buckets(nb)
    for f in plan._fields:
        assert getattr(plan, f) == getattr(jplan, f), f
    levels = JScheme(**kw).init_levels()
    tlevels = QuantScheme(**kw).init_levels("cpu")

    @jax.jit
    def reference(v):
        pay = jc.encode(v, levels, KEY, jplan, use_pallas=False)
        return pay, jc.decode(pay, levels, jplan, use_pallas=False)

    jpay, jvals = reference(jnp.asarray(vb))
    tpay = tc.encode(torch.from_numpy(vb), tlevels, plan=plan,
                     u=_uniforms(KEY, (nb, k)))
    np.testing.assert_array_equal(tpay.words.numpy(),
                                  np.asarray(jpay.words).view(np.int32))
    np.testing.assert_array_equal(tpay.norm_words.numpy(),
                                  np.asarray(jpay.norm_words).view(np.int32))
    as_port = type(tpay)(*(torch.from_numpy(np.array(x).view(np.int32))
                           for x in jpay))
    np.testing.assert_array_equal(tc.decode(as_port, tlevels, plan).numpy(),
                                  np.asarray(jvals))
    sel, idx = tc.select(torch.from_numpy(vb))
    assert bool((idx[1] == torch.arange(k)).all())  # zeros: lowest first


def _reference_compressed(jscheme, spec, grads, mode, steps, codec=None):
    algo = jcompress.make_algorithm(spec, jscheme, codec=codec)
    d = grads.shape[-1]
    cs = algo.init_state(d)
    comp = JCompressState(residual=jnp.zeros((M,) + cs.residual.shape),
                          step=jnp.zeros((M,), jnp.int32))
    state = jscheme.init_state()

    @jax.jit
    def one(g, c, key):
        return jax.vmap(lambda gg, cc: jsync.compressed_allreduce(
            gg, jscheme, state, algo, cc, key, axes=("w",), mode=mode,
            use_pallas=False), axis_name="w")(g, c)

    outs = []
    for t in range(steps):
        out, comp, m = one(jnp.asarray(grads[t]), comp,
                           jax.random.fold_in(KEY, t))
        outs.append((np.asarray(out[0]), np.asarray(comp.residual),
                     jax.tree.map(np.asarray, m)))
    return algo, outs


def _port_uniforms(tc, plan, key, mode):
    k = getattr(tc, "k", plan.bucket_size)
    u = [_uniforms(jax.random.fold_in(key, w), (plan.nb, k))
         for w in range(M)]
    u2 = None
    if mode == "two_phase":
        u2 = [_uniforms(jax.random.fold_in(jax.random.fold_in(key, r),
                                           0x2FA5E),
                        (plan.shard_nb, plan.bucket_size))
              for r in range(M)]
    return u, u2


@pytest.mark.parametrize("spec,mode", [
    ("ef", "all_gather"), ("ef:2", "two_phase"), ("topk", "all_gather"),
    ("topk:30", "two_phase"), ("plain", "two_phase")])
def test_compressed_allreduce_matches_vmapped_reference(spec, mode):
    """Three steps: aggregate, residual rows, residual norms, the warmup
    gate and the wire accounting against the reference."""
    kw = dict(name="qsgdinf", bits=2, bucket_size=256)
    jscheme, scheme = JScheme(**kw), QuantScheme(**kw)
    steps = 3
    grads = np.stack([_grads(M, D, seed=t) for t in range(steps)])
    jalgo, ref = _reference_compressed(jscheme, spec, grads, mode, steps)
    algo = compress.make_algorithm(spec, scheme)
    assert (algo.name, algo.warmup_steps, algo.stateful) == (
        jalgo.name, jalgo.warmup_steps, jalgo.stateful)
    state = (algo.init_state(M, D, "cpu") if algo.stateful else None)
    plan = algo.codec.plan(D, shards=M if mode == "two_phase" else 1)
    for t in range(steps):
        jout, jres, jm = ref[t]
        u, u2 = _port_uniforms(algo.codec, plan,
                               jax.random.fold_in(KEY, t), mode)
        flats = torch.from_numpy(grads[t].copy())
        out, state, m = sync.compressed_allreduce(
            flats, scheme, scheme.init_state("cpu"), algo, state, mode=mode,
            u=u, u2=u2)
        scale = 1e-6 * np.abs(grads[t]).max() * 4
        np.testing.assert_allclose(out.numpy(), jout, rtol=0, atol=scale)
        assert m.kept_fraction == pytest.approx(float(jm.kept_fraction[0]))
        assert m.comm_bits_per_coord == pytest.approx(
            float(jm.comm_bits_per_coord[0]), rel=1e-7)
        np.testing.assert_allclose(m.residual_norm.numpy(),
                                   jm.residual_norm, rtol=1e-5, atol=1e-12)
        if algo.stateful:
            assert state.step == t + 1
            np.testing.assert_allclose(state.residual.numpy(), jres, rtol=0,
                                       atol=scale)
            gate_open = t >= algo.warmup_steps
            assert bool(state.residual.any()) == gate_open
        else:
            assert state is None and not bool(m.residual_norm.any())


def test_plain_algorithm_is_quantized_allreduce_bit_for_bit():
    scheme = QuantScheme(bits=3, bucket_size=256)
    grads = torch.from_numpy(_grads(M, D))
    for mode in ("all_gather", "two_phase"):
        want = sync.quantized_allreduce(
            grads.clone(), scheme, scheme.init_state("cpu"), mode=mode,
            generator=torch.Generator().manual_seed(1))
        got = sync.compressed_allreduce(
            grads.clone(), scheme, scheme.init_state("cpu"),
            compress.make_algorithm("plain", scheme), None, mode=mode,
            generator=torch.Generator().manual_seed(1))
        assert torch.equal(got[0], want[0]) and got[1] is None


def test_ef_forms_its_input_in_the_gradient_rows():
    """prepare adds the residual in place, and the new residual is
    inp - Q(inp) row by row."""
    scheme = QuantScheme(name="qsgdinf", bits=2, bucket_size=256)
    algo = compress.make_algorithm("ef", scheme)
    state = algo.init_state(M, D, "cpu")
    state.residual.copy_(torch.from_numpy(_grads(M, D, seed=9)))
    res0 = state.residual.clone()
    grads = torch.from_numpy(_grads(M, D))
    flats = grads.clone()
    g = torch.Generator().manual_seed(0)
    _, new, _ = sync.compressed_allreduce(
        flats, scheme, scheme.init_state("cpu"), algo, state, generator=g)
    assert torch.equal(flats, grads + res0)
    _, own, _ = sync.quantized_allreduce(
        grads + res0, scheme, scheme.init_state("cpu"), return_own=True,
        generator=torch.Generator().manual_seed(0))
    assert torch.equal(new.residual, flats - own)
    assert new.residual is state.residual and new.step == 1


def test_make_algorithm_specs_and_errors():
    scheme = QuantScheme(bits=3, bucket_size=8192)
    assert compress.make_algorithm("plain", scheme).name == "plain"
    ef = compress.make_algorithm("ef:5", scheme)
    assert isinstance(ef, compress.EFAlgorithm) and ef.warmup_steps == 5
    topk = compress.make_algorithm("topk", scheme)
    assert topk.codec.k == 1927 and topk.name == "topk"
    assert topk.kept_fraction == 1927 / 8192
    assert compress.make_algorithm("topk:64", scheme).codec.k == 64
    jscheme = JScheme(bits=3, bucket_size=8192)
    assert jcompress.make_algorithm("topk", jscheme).codec.k == 1927
    with pytest.raises(ValueError, match="unknown compression algorithm"):
        compress.make_algorithm("powersgd", scheme)
    with pytest.raises(ValueError) as port_err:
        compress.make_algorithm("topk", scheme,
                                codec=codec.codec_for_scheme(scheme))
    with pytest.raises(ValueError) as ref_err:
        jcompress.make_algorithm(
            "topk", jscheme, codec=jcompress.make_algorithm(
                "plain", jscheme).codec)
    assert str(port_err.value) == str(ref_err.value)
    # so topk together with an integrity plan is refused
    with pytest.raises(ValueError, match="cannot compose"):
        _make_algo(TrainConfig(scheme=scheme, compress="topk",
                               integrity=True))
    with pytest.raises(ValueError, match=r"k=0 must be in \[1"):
        compress.SparseCodec(bucket_size=64, k=0)
    # every codec kind of the reference is ported; others are refused
    assert isinstance(codec.make_codec(scheme, "entropy"),
                      codec.EntropyCodec)
    with pytest.raises(ValueError, match="unknown codec kind"):
        codec.make_codec(scheme, "huffman")


@pytest.mark.parametrize("bits,bs", [(1, 256), (2, 1024), (3, 8192),
                                     (4, 100)])
def test_equal_budget_default_k_matches_reference(bits, bs):
    kw = dict(name="alq", bits=bits, bucket_size=bs)
    assert (compress.sparse_codec_for_scheme(QuantScheme(**kw)).k
            == jcompress.sparse_codec_for_scheme(JScheme(**kw)).k)


def test_sparse_requantize_keeps_only_k_per_bucket():
    scheme = QuantScheme(name="qsgdinf", bits=3, bucket_size=128)
    tc = compress.sparse_codec_for_scheme(scheme, k=10)
    vb = torch.from_numpy(_tie_buckets(128, 6))
    out = tc.requantize(vb, scheme.init_levels("cpu"),
                        generator=torch.Generator().manual_seed(0))
    assert out.shape == vb.shape
    assert bool(((out != 0).sum(1) <= 10).all())
    assert not bool(out[1].any())

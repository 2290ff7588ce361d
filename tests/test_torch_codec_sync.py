"""The port's codec and sync layers against the reference package.

Both sides get the same gradients (numpy, from a seed) and the same
uniforms: the test re-derives the reference's draws with ``jax.random``
and hands them to the port.  Symbol words must be bit-exact; norms
within rtol 1e-6 (f32; the norm sums run in another order) or the fp16
step; the port's decode of the reference's words exact; the M=4
aggregate within 1e-6 of its terms' magnitude (same mean order; each
term's norm may differ in the last ulp, and the sum may cancel).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.codec import codec_for_scheme as jcodec_for_scheme
from repro.core.packing import unpack_norms as junpack_norms
from repro.core.schemes import QuantScheme as JScheme
from repro.dist import sync as jsync
from repro_torch.core.codec import codec_for_scheme
from repro_torch.core.packing import unpack_norms
from repro_torch.core.schemes import QuantScheme
from repro_torch.dist import sync

# one thread: xdist workers that each take every core starve one another
torch.set_num_threads(1)


def _grads(M, d, seed=0):
    rng = np.random.default_rng(seed)
    scale = np.exp(rng.standard_normal((M, 1)))
    return (rng.standard_normal((M, d)) * 1e-2 * scale).astype(np.float32)


def _uniforms(key, shape):
    return torch.from_numpy(np.array(
        jax.random.uniform(key, shape, jnp.float32)))


@pytest.mark.parametrize("name,bits,norm_dtype", [
    ("alq", 3, "float32"), ("qsgdinf", 2, "float16"), ("trn", 1, "float32"),
    ("nuqsgd", 8, "float32")])
def test_uniform_codec_encode_decode_match_reference(name, bits, norm_dtype):
    d = 3000
    jscheme = JScheme(name=name, bits=bits, bucket_size=256,
                      norm_dtype=norm_dtype)
    scheme = QuantScheme(name=name, bits=bits, bucket_size=256,
                         norm_dtype=norm_dtype)
    jc, tc = jcodec_for_scheme(jscheme), codec_for_scheme(scheme)
    flat = _grads(1, d)[0]
    jplan, plan = jc.plan(d), tc.plan(d)
    for f in plan._fields:
        assert getattr(plan, f) == getattr(jplan, f), f
    levels = jscheme.init_levels()
    tlevels = scheme.init_levels("cpu")
    np.testing.assert_array_equal(tlevels.numpy(), np.asarray(levels))
    key = jax.random.PRNGKey(5)
    vb = jc.bucketize(jnp.asarray(flat), jplan)

    @jax.jit  # one compiled program instead of one per operation
    def reference(v):
        pay = jc.encode(v, levels, key, jplan, use_pallas=False)
        two = type(pay)(*(jnp.stack([x, x]) for x in pay))
        return (pay, jc.decode(pay, levels, jplan, use_pallas=False),
                jc.decode(two, levels, jplan, use_pallas=False))

    jpay, jone, jtwo = reference(vb)
    tvb = tc.bucketize(torch.from_numpy(flat), plan)
    np.testing.assert_array_equal(tvb.numpy(), np.asarray(vb))
    tpay = tc.encode(tvb, tlevels, u=_uniforms(key, vb.shape))
    np.testing.assert_array_equal(tpay.words.numpy(),
                                  np.asarray(jpay.words).view(np.int32))
    nb = plan.nb
    np.testing.assert_allclose(
        unpack_norms(tpay.norm_words, nb, norm_dtype).numpy(),
        np.asarray(junpack_norms(jpay.norm_words, nb, norm_dtype)),
        rtol=1e-6 if norm_dtype == "float32" else 1e-3)
    # the port decodes the reference's words, one stream and two gathered
    as_port = type(tpay)(*(torch.from_numpy(np.array(x).view(np.int32))
                           for x in jpay))
    np.testing.assert_array_equal(
        tc.decode(as_port, tlevels, plan).numpy(), np.asarray(jone))
    two = type(tpay)(*(torch.stack([x, x]) for x in as_port))
    np.testing.assert_array_equal(
        tc.decode(two, tlevels, plan).numpy(), np.asarray(jtwo))


def test_encode_draws_from_a_generator_when_no_uniforms_are_given():
    scheme = QuantScheme(bucket_size=128)
    codec = codec_for_scheme(scheme)
    plan = codec.plan(1000)
    vb = codec.bucketize(torch.from_numpy(_grads(1, 1000)[0]), plan)
    lv = scheme.init_levels("cpu")

    def enc(seed):
        g = torch.Generator().manual_seed(seed)
        return codec.encode(vb, lv, generator=g).words

    assert torch.equal(enc(1), enc(1))
    assert not torch.equal(enc(1), enc(2))


@pytest.mark.parametrize("name,bits", [("alq", 3), ("qsgdinf", 4)])
def test_m4_allreduce_matches_vmapped_reference(name, bits):
    M, d, bs = 4, 5000, 512
    jscheme = JScheme(name=name, bits=bits, bucket_size=bs)
    scheme = QuantScheme(name=name, bits=bits, bucket_size=bs)
    grads = _grads(M, d, seed=1)
    key = jax.random.PRNGKey(11)
    jstate = jscheme.init_state()

    def worker(g):
        return jsync.quantized_allreduce(g, jscheme, jstate, key,
                                         axes=("w",), use_pallas=True,
                                         return_own=True)

    jout, jown, jm = jax.jit(jax.vmap(worker, axis_name="w"))(
        jnp.asarray(grads))
    nb = jcodec_for_scheme(jscheme).plan(d).nb
    u = [_uniforms(jax.random.fold_in(key, w), (nb, bs)) for w in range(M)]
    out, m = sync.quantized_allreduce(torch.from_numpy(grads), scheme,
                                      scheme.init_state("cpu"), u=u)
    # each decoded term may differ by its norm's last ulp, so the bound
    # is rtol 1e-6 of the terms' mean magnitude (the sum may cancel)
    scale = np.mean(np.abs(np.asarray(jown)), axis=0)
    for w in range(M):  # every reference worker holds the same aggregate
        err = np.abs(out.numpy() - np.asarray(jout[w]))
        assert np.all(err <= 1e-6 * scale + 1e-12), err.max()
    assert m.comm_bits_per_coord == pytest.approx(
        float(jm.comm_bits_per_coord[0]))
    np.testing.assert_allclose(m.quant_error.numpy(),
                               np.asarray(jm.quant_error), rtol=1e-5)


def test_fp32_mode_is_the_plain_mean():
    grads = torch.from_numpy(_grads(3, 100))
    scheme = QuantScheme(name="fp32")
    out, m = sync.quantized_allreduce(grads, scheme,
                                      scheme.init_state("cpu"))
    # the reference's plain mean as XLA compiles it: the sum, then the
    # product with the float32 reciprocal of M (ATen's CPU mean divides)
    want = np.asarray(jax.jit(lambda g: jnp.mean(g, 0))(grads.numpy()))
    np.testing.assert_array_equal(out.numpy().view(np.int32),
                                  want.view(np.int32))
    assert m.comm_bits_per_coord == 32.0

"""The port's aggregation topologies (``repro_torch.sim.topology``)
against the reference's ``repro.sim.run_topology``.

Both packages get the same gradients (numpy, from a seed) and the same
uniforms: the test rebuilds the reference's key schedule with
``jax.random`` and hands the draws to the port.

* allreduce: worker w rounds with fold_in(key, w) (the rank that
  ``quantized_allreduce`` folds in);
* param_server: worker w with fold_in(key, w), the server's downlink with
  fold_in(key, M + 0x5E2F);
* ring: worker w at reduce hop h with fold_in(fold_in(key, 0x11A0 + h),
  w), at gather hop h with fold_in(fold_in(key, 0x22B0 + h), w); the own
  round trip re-uses reduce hop 0's.

The reference runs its kernels' plain versions, jitted once per case
(the ring op by op, see ``_reference``).

Tolerances, each with its reason:
  * byte counts, hops and wire bits/coord exact (the same float32
    arithmetic on the same plans);
  * quant_error rtol 1e-5 (float32 sums in another order);
  * allreduce and fp32 aggregates within 1e-6 of the terms' mean
    magnitude (each decoded term may differ by its norm's last ulp, and
    the sum may cancel), as ``test_torch_codec_sync.py``;
  * the param server's 8-bit downlink by the two_phase tie rule
    (``test_torch_two_phase.py::assert_tie_rule``: within 1e-6 of the
    bucket's L-inf norm, or one 8-bit step off at <= 0.1% of coordinates);
  * the ring by bucket: a (view, bucket) agrees when each of its
    coordinates is within 1e-6 of the bucket's largest |value|.  A
    rounding tie at one hop (the reference's |u - rho| < 1e-5, moved by a
    last-ulp norm) changes that chunk's bucket norm at every later hop,
    and with it every value of the bucket; such buckets may differ, at
    most 1% of them, each by at most 2(M-1) level steps of its scale;
  * error-feedback residuals within 1e-6 of the round trip's scale at
    99.9% of coordinates (a residual is inp - Q(inp)).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_two_phase import assert_tie_rule

from repro import compress as jcompress
from repro.compress import CompressState as JCompressState
from repro.core import codec as jcodec
from repro.core.schemes import QuantScheme as JScheme
from repro.sim import topology as jtopo
from repro_torch import compress
from repro_torch.core import codec
from repro_torch.core.schemes import QuantScheme
from repro_torch.sim import topology

# one thread: xdist workers that each take every core starve one another
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(7)


def _grads(M, d, seed=0):
    rng = np.random.default_rng(seed)
    scale = np.exp(rng.standard_normal((M, 1)))
    return (rng.standard_normal((M, d)) * 1e-2 * scale).astype(np.float32)


def _u(key, shape):
    return torch.from_numpy(np.array(
        jax.random.uniform(key, shape, jnp.float32)))


def _codecs(kind, kw):
    """(reference codec or None, port codec or None) of a codec kind."""
    if kind == "uniform":
        return None, None
    js, ts = JScheme(**kw), QuantScheme(**kw)
    if kind == "mixed":
        widths = (2, 4, 3)
        return (jcodec.MixedWidthCodec(bucket_size=js.bucket_size,
                                       norm_type=js.norm_type,
                                       widths=widths),
                codec.MixedWidthCodec(bucket_size=ts.bucket_size,
                                      norm_type=ts.norm_type, widths=widths))
    if kind == "entropy":
        jc = jcodec.entropy_codec_for_scheme(js)
        # the reference's own table, so the words are held exactly
        return jc, dataclasses.replace(
            codec.entropy_codec_for_scheme(ts), huff_lengths=jc.huff_lengths,
            huff_codes=jc.huff_codes)
    if kind == "topk":
        return (jcompress.sparse_codec_for_scheme(js),
                compress.sparse_codec_for_scheme(ts))
    raise ValueError(kind)


def _port_uniforms(name, M, d, tc, key, server_bits):
    """The reference's draws of this topology, as the port takes them."""
    if name == "ring":
        plan = tc.plan(d, shards=M)
        shape = tc.rounding_shape(plan.shard_nb)
        return {"u_hops": [
            [_u(jax.random.fold_in(jax.random.fold_in(key, base + h), w),
                shape) for w in range(M)]
            for base in (0x11A0, 0x22B0) for h in range(M - 1)]}
    plan = tc.plan(d)
    out = {"u": [_u(jax.random.fold_in(key, w), tc.rounding_shape(plan.nb))
                 for w in range(M)]}
    if name == "param_server" and server_bits is not None:
        out["u_server"] = _u(jax.random.fold_in(key, M + 0x5E2F),
                             (plan.nb, plan.bucket_size))
    return out


def _reference(name, grads, js, *, active=None, jc=None, server_bits=8,
               want_own=False, sync_mode="all_gather"):
    state = js.init_state()

    def run(g, a):
        return jtopo.run_topology(
            name, g, js, state, KEY, active=a, sync_mode=sync_mode,
            server_bits=server_bits, codec=jc, use_pallas=False,
            want_own=want_own)

    # the ring op by op: it unrolls 2(M-1) x M requantizes (M^2 more for
    # the own round trip), whose one program takes longer to compile than
    # its operations take to run; the others as one jitted program
    if name != "ring":
        run = jax.jit(run)
    return run(jnp.asarray(grads),
               None if active is None else jnp.asarray(active, jnp.float32))


def _assert_bytes(res, jres):
    for f in ("sent_bytes", "recv_bytes", "wire_bits_per_coord"):
        got, want = getattr(res, f), np.asarray(getattr(jres, f))
        assert got.dtype == np.float32, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert res.server_bytes == np.float32(jres.server_bytes)
    assert res.hops == int(jres.hops)
    np.testing.assert_allclose(res.quant_error.numpy(),
                               np.asarray(jres.quant_error), rtol=1e-5)


def _assert_terms(out, want, terms):
    """Each coordinate within 1e-6 of its terms' mean magnitude."""
    scale = np.mean(np.abs(terms), axis=0)
    err = np.abs(out - want)
    assert np.all(err <= 1e-6 * scale + 1e-12), err.max()


def assert_ring_rule(out, want, bucket_size, max_gap, hops):
    """The ring's rule (module docstring) over (M, d) views."""
    M, d = want.shape
    n = -(-d // bucket_size) * bucket_size
    pad = ((0, 0), (0, n - d))
    o = np.pad(out, pad).reshape(M, -1, bucket_size)
    w = np.pad(want, pad).reshape(M, -1, bucket_size)
    scale = np.abs(w).max(axis=2, keepdims=True)
    err = np.abs(o - w)
    ok = np.all(err <= 1e-6 * scale + 1e-30, axis=2)
    assert ok.mean() >= 0.99, ok.mean()
    bad = ~ok
    assert np.all(err[bad] <= hops * max_gap * scale[bad] + 1e-30)


def _check(name, out, jout, jres, js, bs, server_bits, M, terms=None):
    if not js.quantized:
        _assert_terms(out, jout, terms)
    elif name == "ring":
        lv = np.asarray(js.init_levels())
        assert_ring_rule(out, jout, bs, np.diff(lv).max(), 2 * (M - 1))
    elif name == "param_server" and server_bits is not None:
        for w in range(M):
            assert_tie_rule(out[w], jout[w], bs)
    else:
        _assert_terms(out, jout, terms)


CASES = [
    # name, M, d, scheme kwargs, codec kind, active, server_bits
    ("allreduce", 4, 5000, dict(name="alq", bits=3), "uniform", None, 8),
    ("allreduce", 3, 4000, dict(name="qsgdinf", bits=4), "uniform",
     (1.0, 0.0, 1.0), 8),
    ("allreduce", 4, 5000, dict(name="alq", bits=3), "uniform",
     (1.0, 0.5, 1.0, 0.0), 8),
    ("param_server", 4, 5000, dict(name="alq", bits=3), "uniform", None, 8),
    ("param_server", 4, 5000, dict(name="alq", bits=3), "uniform", None,
     None),
    ("param_server", 3, 4000, dict(name="qsgdinf", bits=2), "uniform",
     None, 8),
    ("param_server", 4, 5000, dict(name="alq", bits=3), "uniform",
     (1.0, 0.0, 1.0, 1.0), 8),
    ("param_server", 4, 5000, dict(name="alq", bits=3), "uniform",
     (1.0, 0.5, 1.0, 0.0), None),
    ("ring", 4, 5000, dict(name="alq", bits=3), "uniform", None, 8),
    ("ring", 3, 4000, dict(name="qsgdinf", bits=3), "uniform", None, 8),
    ("ring", 8, 9000, dict(name="alq", bits=3), "uniform", None, 8),
    ("ring", 4, 5000, dict(name="alq", bits=3), "uniform",
     (1.0, 0.5, 1.0, 0.0), 8),
    ("allreduce", 4, 3000, dict(name="fp32"), "uniform", None, 8),
    ("param_server", 4, 3000, dict(name="fp32"), "uniform", None, 8),
    ("ring", 4, 3000, dict(name="fp32"), "uniform", (1.0, 0.0, 1.0, 1.0),
     8),
    ("allreduce", 4, 5000, dict(name="alq", bits=3), "mixed", None, 8),
    ("param_server", 4, 5000, dict(name="alq", bits=3), "mixed", None, 8),
    ("ring", 4, 5000, dict(name="alq", bits=3), "mixed", None, 8),
    ("allreduce", 4, 2000, dict(name="alq", bits=3, bucket_size=64),
     "entropy", None, 8),
    ("param_server", 4, 2000, dict(name="alq", bits=3, bucket_size=64),
     "entropy", None, 8),
    ("allreduce", 4, 5000, dict(name="qsgdinf", bits=2), "topk", None, 8),
    ("param_server", 4, 5000, dict(name="qsgdinf", bits=2), "topk", None,
     8),
    ("ring", 4, 5000, dict(name="qsgdinf", bits=2), "topk", None, 8),
]


@pytest.mark.parametrize("case", CASES, ids=[
    f"{c[0]}-M{c[1]}-{c[3]['name']}-{c[4]}-{'mask' if c[5] else 'all'}"
    f"-sb{c[6]}" for c in CASES])
def test_topology_matches_reference(case):
    name, M, d, kw, kind, active, server_bits = case
    kw = {"bucket_size": 256, **kw}
    js, ts = JScheme(**kw), QuantScheme(**kw)
    jc, tc = _codecs(kind, kw)
    grads = _grads(M, d, seed=M)
    jres = _reference(name, grads, js, active=active, jc=jc,
                      server_bits=server_bits, want_own=True)
    u = {}
    if ts.quantized:
        u = _port_uniforms(name, M, d, tc or codec.codec_for_scheme(ts),
                           KEY, server_bits)
    g = torch.from_numpy(grads.copy())
    res = topology.run_topology(
        name, g, ts, ts.init_state("cpu"), active=active,
        server_bits=server_bits, codec=tc, want_own=True, **u)
    assert torch.equal(g, torch.from_numpy(grads))    # inputs untouched
    assert res.aggregate.shape == (M, d)
    _assert_bytes(res, jres)
    _check(name, res.aggregate.numpy(), np.asarray(jres.aggregate), jres,
           js, kw["bucket_size"], server_bits, M,
           terms=np.asarray(jres.own))
    # each worker's own round trip: one quantization of its input
    own, jown = res.own.numpy(), np.asarray(jres.own)
    err = np.abs(own - jown)
    assert (err <= 1e-6 * np.abs(jown).max()).mean() >= 0.999
    assert res.corrupt_fraction == float(jres.corrupt_fraction) == 0.0


def test_two_phase_allreduce_topology_matches_reference():
    """The allreduce topology's two_phase wire: per-direction bytes."""
    M, d = 4, 9000
    kw = dict(name="alq", bits=3, bucket_size=256)
    js, ts = JScheme(**kw), QuantScheme(**kw)
    grads = _grads(M, d, seed=2)
    jres = _reference("allreduce", grads, js, sync_mode="two_phase")
    tc = codec.codec_for_scheme(ts)
    plan = tc.plan(d, shards=M)
    wkeys = [jax.random.fold_in(KEY, w) for w in range(M)]
    u = [_u(k, (plan.nb, plan.bucket_size)) for k in wkeys]
    u2 = [_u(jax.random.fold_in(k, 0x2FA5E), (plan.shard_nb,
                                                plan.bucket_size))
          for k in wkeys]
    res = topology.run_topology("allreduce", torch.from_numpy(grads), ts,
                                ts.init_state("cpu"), sync_mode="two_phase",
                                u=u, u2=u2)
    _assert_bytes(res, jres)
    assert res.hops == 2
    for w in range(M):
        assert_tie_rule(res.aggregate[w].numpy(),
                        np.asarray(jres.aggregate[w]), plan.bucket_size)


def test_param_server_without_downlink_grid_is_the_allreduce():
    """On a homogeneous cluster with a raw fp32 downlink, the param server
    is the allreduce bit for bit (the same encodes, decode and mean); the
    8-bit downlink only adds noise."""
    M, d = 4, 6000
    ts = QuantScheme(bits=3, bucket_size=256)
    g = torch.from_numpy(_grads(M, d, seed=5))

    def run(name, bits):
        gen = torch.Generator().manual_seed(1)
        return topology.run_topology(name, g, ts, ts.init_state("cpu"),
                                     server_bits=bits, generator=gen)

    ar, ps, ps8 = run("allreduce", 8), run("param_server", None), \
        run("param_server", 8)
    assert torch.equal(ar.aggregate, ps.aggregate)
    assert torch.equal(ar.quant_error, ps.quant_error)
    exact = g.mean(0)
    err = [float(torch.sum((r.aggregate[0] - exact) ** 2))
           for r in (ar, ps8)]
    assert err[1] > err[0]


def test_ring_compounds_error_and_fp32_ring_is_exact():
    M, d = 8, 9000
    g = torch.from_numpy(_grads(M, d, seed=6))
    exact = g.mean(0)
    ts = QuantScheme(bits=3, bucket_size=256)
    gen = torch.Generator().manual_seed(2)
    ring = topology.run_topology("ring", g, ts, ts.init_state("cpu"),
                                 generator=gen)
    ar = topology.run_topology("allreduce", g, ts, ts.init_state("cpu"),
                               generator=gen)
    e_ring = torch.sum((ring.aggregate - exact) ** 2, dim=1)
    e_ar = torch.sum((ar.aggregate[0] - exact) ** 2)
    assert bool((e_ring > e_ar).all())
    f32 = QuantScheme(name="fp32")
    exact32 = topology.run_topology("ring", g, f32, f32.init_state("cpu"))
    torch.testing.assert_close(exact32.aggregate,
                               exact.expand(M, d), rtol=1e-6, atol=1e-9)
    assert float(exact32.quant_error.sum()) == 0.0


def test_wire_faults_only_on_the_allreduce():
    from repro_torch.dist.faults import FaultModel
    ts = QuantScheme(bits=3, bucket_size=256)
    g = torch.from_numpy(_grads(4, 2000))
    with pytest.raises(ValueError, match="allreduce"):
        topology.run_topology("ring", g, ts, ts.init_state("cpu"),
                              fault=FaultModel(flip_prob=0.1))
    with pytest.raises(ValueError, match="unknown topology"):
        topology.run_topology("mesh", g, ts, ts.init_state("cpu"))


@pytest.mark.parametrize("name", topology.TOPOLOGIES)
def test_run_compressed_ef_matches_reference(name):
    """``run_compressed`` with error feedback: the aggregate of the
    residual-corrected inputs and every worker's new residual."""
    M, d = 4, 5000
    kw = dict(name="qsgdinf", bits=2, bucket_size=256)
    js, ts = JScheme(**kw), QuantScheme(**kw)
    grads = _grads(M, d, seed=7)
    resid = (np.random.default_rng(8).standard_normal((M, d)) * 3e-3
             ).astype(np.float32)
    jalgo = jcompress.make_algorithm("ef", js)
    jstate = JCompressState(residual=jnp.asarray(resid),
                            step=jnp.zeros((M,), jnp.int32))
    state = js.init_state()

    def reference(g, cs):
        return jtopo.run_compressed(name, g, js, state, jalgo, cs, KEY,
                                    server_bits=8, use_pallas=False)

    if name != "ring":   # as in _reference
        reference = jax.jit(reference)
    jres, jnew = reference(jnp.asarray(grads), jstate)
    algo = compress.make_algorithm("ef", ts)
    cs = algo.init_state(M, d, "cpu")
    cs.residual.copy_(torch.from_numpy(resid))
    u = _port_uniforms(name, M, d, algo.codec, KEY, 8)
    res, new = topology.run_compressed(
        name, torch.from_numpy(grads.copy()), ts, ts.init_state("cpu"),
        algo, cs, server_bits=8, **u)
    _assert_bytes(res, jres)
    inp = grads + resid
    _check(name, res.aggregate.numpy(), np.asarray(jres.aggregate), jres,
           js, 256, 8, M, terms=inp - np.asarray(jnew.residual))
    r, jr = new.residual.numpy(), np.asarray(jnew.residual)
    close = np.abs(r - jr) <= 1e-6 * np.abs(inp - jr).max()
    assert close.mean() >= 0.999, close.mean()
    assert new.step == 1


def test_run_compressed_plain_is_run_topology():
    M, d = 4, 4000
    ts = QuantScheme(bits=3, bucket_size=256)
    g = torch.from_numpy(_grads(M, d, seed=9))
    algo = compress.make_algorithm("plain", ts)
    for name in topology.TOPOLOGIES:
        a, _ = topology.run_compressed(
            name, g.clone(), ts, ts.init_state("cpu"), algo, None,
            generator=torch.Generator().manual_seed(3))
        b = topology.run_topology(name, g, ts, ts.init_state("cpu"),
                                  generator=torch.Generator().manual_seed(3))
        assert torch.equal(a.aggregate, b.aggregate), name

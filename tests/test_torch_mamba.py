"""The port's Mamba mixer (``models/mamba.py``) against the reference's
``mamba.py``, run at tp = 1 inside a (1, 1) mesh as the reference's
model runs it.

Inputs are made with numpy from a seed, at jamba-smoke's dims (d 128,
d_inner 256, d_state 8, dt_rank 8, conv 4), every leaf non-zero: the
init's zero conv weights would make the mixer's output exactly 0 and
hide the scan.  A_log is drawn near the init's log(1..d_state).

  * ``_causal_conv``: bit-exact against the reference run op by op (the
    same products added in the same order), and within an ulp an
    addition of its jitted run (XLA fuses a multiply and add);
  * ``_ssm_scan`` at S = 16 (one chunk shorter than 64), 64 and 192
    (three chunks, the state carried across) from a non-zero state:
    within 1e-6 of the largest state (float32; the port follows
    ``associative_scan``'s combine tree, and XLA may fuse a combine's
    multiply and add);
  * ``mamba_forward`` and its gradients (x and every leaf) at S = 32 and
    S = 128 (two chunks): output rtol 1e-5, gradients within 1e-4 of
    their largest entry, as ``test_torch_model.py`` holds the models.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.models import mamba as jmamba
from repro.models.layers import TPCtx, make_dims
from repro_torch import configs
from repro_torch.models import mamba

# one thread: xdist workers that each take every core starve one another
torch.set_num_threads(1)

ARCH = "jamba-1.5-large-398b"


def _params(cfg, seed):
    rng = np.random.default_rng(seed)
    p = {}
    for name, (shape, code) in mamba.mamba_specs(cfg).items():
        z = rng.standard_normal(shape)
        if name == "A_log":
            v = np.log(np.arange(1, shape[-1] + 1)) + 0.1 * z
        elif name in ("conv_w", "conv_b", "dt_bias", "D"):
            v = 0.5 * z
        else:
            v = z / np.sqrt(code)
        p[name] = v.astype(np.float32)
    return p


def _in_mesh(f, *args):
    """``f`` jitted inside the reference's (1, 1) shard_map."""
    specs = jax.tree.map(lambda _: P(), args)
    with jax.set_mesh(jax.make_mesh((1, 1), ("data", "model"))):
        fn = jax.jit(jax.shard_map(f, in_specs=specs, out_specs=P(),
                                   check_vma=False))
        out = fn(*jax.tree.map(jnp.asarray, args))
    return jax.tree.map(np.asarray, out)


def test_specs_match_reference():
    jcfg = jconfigs.get_smoke_config(ARCH)
    cfg = configs.get_smoke_config(ARCH)
    want = jmamba.mamba_param_specs(jcfg, make_dims(jcfg, 1), 1)
    assert mamba.mamba_specs(cfg) == want
    assert mamba.mamba_dims(cfg) == jmamba.mamba_dims(jcfg, 1)[0] == 256


@pytest.mark.parametrize("S", [1, 3, 40])
def test_causal_conv_is_bit_exact(S):
    """Bit-exact against the reference run op by op; jitted, XLA fuses
    each multiply and add into one rounding, so there within an ulp of
    each of the four additions (2^-23 of the sum of |terms| each)."""
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 64)).astype(np.float32)
    w = rng.standard_normal((4, 64)).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    got = mamba._causal_conv(*map(torch.from_numpy, (x, w, b)))[0].numpy()
    with jax.disable_jit():
        eager, _ = jmamba._causal_conv(*map(jnp.asarray, (x, w, b)), 4)
    np.testing.assert_array_equal(got, np.asarray(eager))
    fused, _ = jax.jit(lambda x, w, b: jmamba._causal_conv(x, w, b, 4))(
        x, w, b)
    xp = np.concatenate([np.zeros((2, 3, 64), np.float32), x], axis=1)
    terms = np.abs(b) + sum(np.abs(w[j] * xp[:, j:j + S]) for j in range(4))
    assert np.all(np.abs(got - np.asarray(fused)) <= 4 * 2.0 ** -23 * terms)


@pytest.mark.parametrize("S", [16, 64, 192])
def test_ssm_scan_matches_reference(S):
    rng = np.random.default_rng(S)
    shape = (2, S, 24, 8)
    decay = rng.uniform(0.3, 1.0, shape).astype(np.float32)
    drive = rng.standard_normal(shape).astype(np.float32)
    h0 = rng.standard_normal((2, 24, 8)).astype(np.float32)
    want_last, want = jax.jit(
        lambda a, b, h: jmamba._ssm_scan(a, b, h, jmamba.MAMBA_CHUNK))(
            decay, drive, h0)
    last, hs = mamba._ssm_scan(*map(torch.from_numpy, (decay, drive, h0)))
    top = np.abs(np.asarray(want)).max()
    assert np.abs(hs.numpy() - np.asarray(want)).max() <= 1e-6 * top
    np.testing.assert_array_equal(hs[:, -1].numpy(), last.numpy())
    assert np.abs(last.numpy() - np.asarray(want_last)).max() <= 1e-6 * top


def test_associative_scan_order_is_the_reference():
    """Odd and even lengths through the recursion, against
    ``jax.lax.associative_scan`` itself (eager, op by op, so that no
    fusion moves a rounding): bit-exact."""
    def combine(a, b):
        return a[0] * b[0], a[1] * b[0] + b[1]

    rng = np.random.default_rng(5)
    for n in (1, 2, 5, 7, 12, 64):
        a = rng.uniform(0.3, 1.0, (2, n, 3)).astype(np.float32)
        b = rng.standard_normal((2, n, 3)).astype(np.float32)
        with jax.disable_jit():
            want = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                      jnp.asarray(b)), axis=1)
        got = mamba._assoc_scan([torch.from_numpy(a), torch.from_numpy(b)])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("S", [32, 128])
def test_mamba_forward_and_gradients_match_reference(S):
    jcfg = jconfigs.get_smoke_config(ARCH)
    cfg = configs.get_smoke_config(ARCH)
    p = _params(cfg, seed=S)
    rng = np.random.default_rng(S + 1)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    dy = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    ctx = TPCtx(tp=1, dp=1, compute_dtype=jnp.float32)
    dims = make_dims(jcfg, 1)

    def f(p, x, dy):
        def obj(p, x):
            y, _ = jmamba.mamba_forward(ctx, jcfg, dims, p, x)
            return jnp.sum(y * dy), y

        (_, y), grads = jax.value_and_grad(obj, argnums=(0, 1),
                                           has_aux=True)(p, x)
        return y, grads

    want, (jgp, jgx) = _in_mesh(f, p, x, dy)
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y = mamba.mamba_forward(cfg, tp, tx)
    (y * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    for name, got, w in [("x", tx.grad, jgx)] + [
            (k, tp[k].grad, jgp[k]) for k in tp]:
        err = np.abs(got.numpy() - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (name, err)

"""How the reference rounds where its source divides, on the CPU: for each
case, how many of the float32 results part from a true division and how
many from the product with the divisor's float32 reciprocal.

    PYTHONPATH=src JAX_PLATFORMS=cpu python experiments/reference_division.py

The cases: the jitted ``jnp.mean(x, 0)`` over M = 3, 5, 6 rows (its HLO's
divisor constant printed), ``psum(x) / M`` and ``psum_scatter(x) / M``
under ``vmap``, the micro-batch mean ``g / 3`` jitted, and AdamW's
``m / c1`` with ``c1`` an array (as from the traced step) eager and
jitted; against them the port's ``numerics.worker_mean``; and ATen's CPU
float32 ``sqrt`` against numpy's, which is correctly rounded.  Prints one
JSON object.
"""
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch import numerics

N = 4096


def rows(M, n, seed):
    rng = np.random.default_rng(seed)
    scale = np.exp(3.0 * rng.standard_normal((M, 1)))
    return (rng.standard_normal((M, n)) * scale).astype(np.float32)


def seq_sum(x):
    s = np.zeros(x.shape[1:], np.float32)
    for r in x:
        s = (s + r).astype(np.float32)
    return s


def parts(got, div, rec) -> dict:
    got = np.asarray(got, np.float32).view(np.int32)
    return {"from_division": int((got != div.view(np.int32)).sum()),
            "from_reciprocal": int((got != rec.view(np.int32)).sum()),
            "of": int(got.size)}


def main() -> None:
    out = {}
    for M in (3, 5, 6):
        x = rows(M, N, seed=M)
        s = seq_sum(x)
        div = (s / np.float32(M)).astype(np.float32)
        rec = (s * (np.float32(1) / np.float32(M))).astype(np.float32)
        mean = jax.jit(lambda a: jnp.mean(a, 0))
        hlo = mean.lower(x).compile().as_text()
        psum = jax.jit(jax.vmap(lambda g: jax.lax.psum(g, "d") / M,
                                axis_name="d"))
        xs = rows(M, M * 64, seed=10 + M)
        ss = seq_sum(xs.reshape(M, M, 64))
        scatter = jax.jit(jax.vmap(
            lambda g: jax.lax.psum_scatter(g, "d", scatter_dimension=0,
                                           tiled=True) / M, axis_name="d"))
        out[f"M={M}"] = {
            "jnp.mean(x, 0)": parts(mean(x), div, rec),
            "hlo_constants": re.findall(r"constant\(([-0-9.e]+)\)", hlo),
            "psum / M": parts(psum(x)[0], div, rec),
            "psum_scatter / M": parts(
                scatter(xs), (ss / np.float32(M)).astype(np.float32),
                (ss * (np.float32(1) / np.float32(M))).astype(np.float32)),
            "numerics.worker_mean": parts(
                numerics.worker_mean(torch.from_numpy(x)).numpy(), div, rec),
        }
    g = rows(1, N, seed=20)[0]
    out["g / 3 jitted"] = parts(
        jax.jit(lambda a: a / 3)(g), (g / np.float32(3)).astype(np.float32),
        (g * (np.float32(1) / np.float32(3))).astype(np.float32))
    c1 = np.float32(1) - np.float32(0.9)
    m = rows(1, N, seed=21)[0]
    div = (m / c1).astype(np.float32)
    rec = (m * (np.float32(1) / c1)).astype(np.float32)
    out["m / c1 eager"] = parts(jnp.asarray(m) / jnp.asarray(c1), div, rec)
    out["m / c1 jitted"] = parts(
        jax.jit(lambda a, c: a / c)(m, c1), div, rec)
    v = np.abs(rows(1, 1_000_003, seed=22)[0])
    for name, got in (("torch.sqrt", torch.sqrt(torch.from_numpy(v))),
                      ("numerics.sqrt", numerics.sqrt(torch.from_numpy(v)))):
        out[f"{name} against numpy, float32"] = {
            "differ": int((got.numpy().view(np.int32)
                           != np.sqrt(v).view(np.int32)).sum()),
            "of": int(v.size)}
    out["versions"] = {"jax": jax.__version__, "torch": torch.__version__}
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()

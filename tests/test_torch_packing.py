"""The port's bit packing against ``repro.core.packing``: packed words
are bit-exact (the port carries uint32 words as int32 bit patterns) for
widths 1-8, for fp32 and fp16 norm words, and across chunk boundaries."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jpack
from repro_torch.core import packing as tpack

# one thread: xdist workers that each take every core starve one another
torch.set_num_threads(1)


def _words(w):
    return np.asarray(w).view(np.int32)


# one compiled program per shape instead of one per operation
_jpack = jax.jit(jpack.pack, static_argnums=1)


@functools.partial(jax.jit, static_argnums=1)
def _jpack_unpack(sym, bits):
    words = jpack.pack(sym, bits)
    return words, jpack.unpack(words, sym.shape[0], bits)


@pytest.mark.parametrize("bits", range(1, 9))
@pytest.mark.parametrize("n", [33, 4099])
def test_pack_is_bit_exact_and_round_trips(bits, n):
    rng = np.random.default_rng([bits, n])
    sym = rng.integers(0, 2 ** bits, size=n).astype(np.int32)
    want, want_back = _jpack_unpack(jnp.asarray(sym), bits)
    got = tpack.pack(torch.from_numpy(sym), bits)
    assert got.dtype == torch.int32
    assert got.numel() == tpack.packed_words(n, bits) == want.shape[0]
    np.testing.assert_array_equal(got.numpy(), _words(want))
    back = tpack.unpack(got, n, bits)
    np.testing.assert_array_equal(back.numpy(), sym)
    np.testing.assert_array_equal(back.numpy(), np.asarray(want_back))


@pytest.mark.parametrize("bits", [3, 4, 7])
def test_chunked_pack_matches_one_piece(bits, monkeypatch):
    n = 5000 + bits
    rng = np.random.default_rng(bits)
    sym = rng.integers(0, 2 ** bits, size=n).astype(np.int32)
    want = _words(_jpack(jnp.asarray(sym), bits))
    monkeypatch.setattr(tpack, "CHUNK_SYMBOLS", 32 * 17)
    got = tpack.pack(torch.from_numpy(sym), bits)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tpack.unpack(got, n, bits).numpy(), sym)


@pytest.mark.parametrize("num_levels", [2, 4, 8, 16, 256])
def test_signed_codes_pack_like_the_reference(num_levels):
    rng = np.random.default_rng(num_levels)
    codes = rng.integers(-(num_levels - 1), num_levels, size=777)
    want = jax.jit(jpack.pack_signed, static_argnums=1)(
        jnp.asarray(codes, jnp.int32), num_levels)
    got = tpack.pack_signed(torch.from_numpy(codes), num_levels)
    np.testing.assert_array_equal(got.numpy(), _words(want))
    np.testing.assert_array_equal(
        tpack.unpack_signed(got, 777, num_levels).numpy(), codes)
    assert tpack.wire_bits_for(num_levels) == jpack.wire_bits_for(num_levels)


@pytest.mark.parametrize("norm_dtype", ["float32", "float16"])
@pytest.mark.parametrize("nb", [6, 7])
def test_norm_words_are_bit_exact(norm_dtype, nb):
    rng = np.random.default_rng(nb)
    norms = (rng.random(nb) * 3 + 1e-3).astype(np.float32)
    want = jax.jit(jpack.pack_norms, static_argnums=1)(jnp.asarray(norms),
                                                       norm_dtype)
    got = tpack.pack_norms(torch.from_numpy(norms), norm_dtype)
    assert got.numel() == tpack.norm_words(nb, norm_dtype)
    np.testing.assert_array_equal(got.numpy(), _words(want))
    np.testing.assert_array_equal(
        tpack.unpack_norms(got, nb, norm_dtype).numpy(),
        np.asarray(jax.jit(jpack.unpack_norms, static_argnums=(1, 2))(
            want, nb, norm_dtype)))

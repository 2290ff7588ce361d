"""The port's host-side coding tables (``core/coding.py``) against the
reference package.

The Huffman construction, the signed-symbol alphabet, the canonical
codewords and the wire table are numpy and ``heapq`` in both packages, so
the same probabilities give the same integer tables: lengths and codewords
are held exact, and the floats computed from them (expected Huffman bits)
at rtol 1e-6.  The functions that start from level occupancies under a
fitted mixture (``expected_bits_per_coordinate``, ``code_length_bound``)
take the port's ``level_probabilities``, whose float32 erf and exp differ
from the reference's in the last ulps (``test_torch_levels.py`` holds them
at rtol 1e-5): those are held at rtol 1e-5, on grids whose Huffman lengths
have no near-tie for that noise to flip.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coding as jcoding
from repro.core.levels import exp_levels as jexp_levels
from repro.core.stats import TruncNormStats as JStats
from repro_torch.core import coding
from repro_torch.core.stats import TruncNormStats

# one thread: xdist workers that each take every core starve one another
torch.set_num_threads(1)


def _probs(n, seed, ties=False):
    rng = np.random.default_rng(seed)
    p = rng.random(n) ** 3
    if ties:   # equal pairs, as the signed alphabet has
        p[1::2] = p[0:-1:2]
    return p / p.sum()


@pytest.mark.parametrize("n,ties", [(1, False), (2, False), (7, False),
                                    (15, True), (255, True), (511, False)])
def test_huffman_lengths_and_expected_bits_match(n, ties):
    p = _probs(n, n, ties)
    np.testing.assert_array_equal(coding.huffman_code_lengths(p),
                                  jcoding.huffman_code_lengths(p))
    np.testing.assert_allclose(coding.expected_huffman_bits(p),
                               jcoding.expected_huffman_bits(p), rtol=1e-6)


@pytest.mark.parametrize("L", [1, 2, 8, 256])
def test_signed_alphabet_and_canonical_codes_match(L):
    p = _probs(L, L)
    joint = coding.signed_symbol_probabilities(p)
    np.testing.assert_array_equal(joint,
                                  jcoding.signed_symbol_probabilities(p))
    lengths = jcoding.huffman_code_lengths(joint)
    np.testing.assert_array_equal(coding.canonical_code(lengths),
                                  jcoding.canonical_code(lengths))


@pytest.mark.parametrize("bits", range(1, 9))
def test_entropy_tables_match_for_the_same_probabilities(bits):
    L = 2 ** bits
    assert coding.entropy_table(None, L) == jcoding.entropy_table(None, L)
    for seed in range(3):
        p = _probs(L, 100 * bits + seed, ties=seed == 1)
        if seed == 2:
            p[L // 2:] = 0.0          # never-seen levels: the floor applies
            p /= p.sum()
        got = coding.entropy_table(p, L)
        assert got == jcoding.entropy_table(p, L)
        lengths, codes = got
        assert all(1 <= n <= coding.MAX_CODE_BITS for n in lengths)
        assert len(lengths) == len(codes) == 2 * L - 1


def test_entropy_table_refuses_a_wrong_level_count():
    with pytest.raises(ValueError, match="levels"):
        coding.entropy_table(np.ones(4) / 4, 8)


def test_over_long_codes_fall_back_to_fixed_width(monkeypatch):
    """A table whose longest code exceeds MAX_CODE_BITS becomes the
    fixed-width code in both packages (forced here by lowering the limit
    on both sides, since the probability floor keeps real tables far
    inside 32 bits)."""
    monkeypatch.setattr(coding, "MAX_CODE_BITS", 4)
    monkeypatch.setattr(jcoding, "MAX_CODE_BITS", 4)
    p = np.array([0.9, 0.05, 0.03, 0.01, 0.005, 0.003, 0.0015, 0.0005])
    got = coding.entropy_table(p, 8)
    assert got == jcoding.entropy_table(p, 8)
    assert set(got[0]) == {4}


@pytest.mark.parametrize("bits", [2, 3])
def test_expected_bits_and_bound_match(bits):
    lv = np.array(jexp_levels(bits, 0.5))
    kw = dict(mu=[0.05, 0.2], sigma=[0.1, 0.3], gamma=[0.7, 0.3])
    js = JStats(**{k: jnp.asarray(v, jnp.float32) for k, v in kw.items()})
    ts = TruncNormStats(**{k: torch.tensor(v) for k, v in kw.items()})
    for use_huffman in (True, False):
        np.testing.assert_allclose(
            coding.expected_bits_per_coordinate(
                torch.from_numpy(lv), ts, use_huffman=use_huffman),
            jcoding.expected_bits_per_coordinate(
                jnp.asarray(lv), js, use_huffman=use_huffman), rtol=1e-5)
    for d in (1000, 10 ** 6):
        np.testing.assert_allclose(
            coding.code_length_bound(torch.from_numpy(lv), ts, d),
            jcoding.code_length_bound(jnp.asarray(lv), js, d), rtol=1e-5)

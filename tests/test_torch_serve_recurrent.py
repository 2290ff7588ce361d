"""Serving in the port against the reference's for the recurrent and
cross-attention families: RWKV6, the Mamba hybrid with MoE every other
layer (capacity factor 8, as the reference's test, so that nothing
drops) and the VLM with image embeddings fed to prefill and decode, in
the configs of ``test_decode_consistency.py``.

The same checks as ``test_torch_serve.py`` (whose helpers this file
uses): prefill's logits and caches against the reference's, three decode
steps from the reference's caches, and the port's prefill and decode
against its own full forward (prompt 24, positions to 26).  RWKV6's
token-shift mixes, w0 and LoRA are drawn as a trained model has them,
and Mamba's conv and the VLM's cross gate are drawn non-zero (zero at
init, which would hide both blocks).

Tolerances (float32): logits within 1e-5 of their largest entry; RWKV6's
state and previous token, attention's K and V within 1e-6 of their
largest entry; Mamba's state and conv inputs within 1e-5 (slice 8's
standing band for XLA's fused multiply-adds in the scan and the conv,
carried through the layers); the consistency check within 1e-5 of the
largest logit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.models import moe as jmoe
from repro.models.layers import TPCtx
from repro_torch.models import moe
from test_torch_moe import _cfgs, _inputs
from test_torch_serve import (B, MAX_LEN, N_DECODE, S, case, check_consistency,
                              check_decode, check_prefill, close)

# one thread: xdist workers that each take every core starve one another
torch.set_num_threads(1)

CONFIGS = {
    "rwkv": dict(arch_type="ssm", layer_pattern="rwkv", rwkv_head_dim=32),
    "hybrid-moe": dict(arch_type="hybrid", layer_pattern="mamba_hybrid",
                       attn_every=2, moe=True, num_experts=4, top_k=2,
                       moe_every=2, capacity_factor=8.0, num_layers=4),
    "vlm": dict(arch_type="vlm", cross_attn_every=2),
}
# Mamba's leaves under XLA's fusion (test_torch_mamba.py)
CACHE_TOL = {"rwkv": 1e-6, "hybrid-moe": 1e-5, "vlm": 1e-6}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_matches_reference(name):
    check_prefill(name, CACHE_TOL[name])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_from_reference_caches_matches_reference(name):
    check_decode(name, CACHE_TOL[name])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_and_decode_match_full_forward(name):
    model, ids, vision, _ = case(name)
    check_consistency(model, ids, vision, S, S + N_DECODE - 1, MAX_LEN)


def test_recurrent_cache_layout():
    """RWKV6: (state (G, B, H, hd, hd) float32, prev_x (G, B, 1, d));
    Mamba: (h (G, B, d_inner, d_state) float32, conv (G, B, width - 1,
    d_inner)); both from ``init_cache`` as from prefill (the hybrid's
    attention slot holds (k, v))."""
    for name in ("rwkv", "hybrid-moe"):
        model, ids, _, ref = case(name)
        zero = model.init_cache(B, MAX_LEN)
        _, caches = model.prefill(ids[:, :S], max_len=MAX_LEN)
        for slot, (z, c, r) in enumerate(zip(zero, caches, ref[0][1])):
            assert [t.shape for t in z] == [t.shape for t in c] == [
                torch.Size(np.shape(t)) for t in r]
            if model.cfg.slot_kind(slot) != "attn":
                assert z[0].dtype == c[0].dtype == torch.float32
    cfg = case("rwkv")[0].cfg
    assert case("rwkv")[0].init_cache(B, MAX_LEN)[0][0].shape == (
        cfg.num_layers, B, 2, 32, 32)


@pytest.mark.parametrize("batch", [1, 8, 40])
def test_moe_ffn_of_a_decode_step_matches_reference(batch):
    """A decode step routes B tokens: ``moe_ffn`` on (B, 1, d) runs at the
    reference's ``capacity(cfg, B)`` (at least 8 slots; 40 tokens at
    factor 1.25 give 32, where pairs may drop) and gives its output,
    within 1e-5 of the largest entry."""
    jcfg, cfg = _cfgs("mixtral-8x7b", {})
    assert moe.capacity(cfg, batch) == jmoe.capacity(jcfg, batch) >= 8
    p, x, _ = _inputs(cfg, batch)
    x = x.reshape(-1, cfg.d_model)[:batch, None]
    ctx = TPCtx(tp=1, dp=1, compute_dtype=jnp.float32)
    with jax.set_mesh(jax.make_mesh((1, 1), ("data", "model"))):
        want = jax.jit(jax.shard_map(
            lambda p, x: jmoe.moe_ffn(ctx, jcfg, p, x)[0],
            in_specs=(P(), P()), out_specs=P(), check_vma=False))(p, x)
    y, _ = moe.moe_ffn(cfg, {k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x))
    close(y, want, 1e-5, f"moe_ffn of {batch} tokens")

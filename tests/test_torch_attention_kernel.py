"""The attention kernels' dispatch and arguments, on the CPU.

``models/attention.py::_self_attention`` hands CPU tensors to the plain
``_flash`` over expanded kv heads and every other tensor to the kernels
of ``kernels/attention.py`` (meta tensors to their operators, for the
dry run's count), which take bfloat16 and float32 and raise on anything
else; here CPU tensors must take ``_flash`` (the same bits as before the
kernels existed) and launch nothing.  The kernels read kv head
``_kv_heads(...)[h]`` for q head h: that map must pick the heads
``_expand`` copies, at tp 1 and at tp > 1 with padding heads.  The
wrapper's argument check refuses what the kernels do not take.  The
kernels themselves run only on the card (``test_torch_cuda.py``).
"""
import dataclasses
import re

import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import attention as kattn
from repro_torch.kernels import cuda
from repro_torch.models import attention
from repro_torch.models.config import CHUNKED, FULL, SLIDING
from repro_torch.models.layers import TP1, TPCtx, make_dims

# one thread: xdist workers that each take every core starve one another
torch.set_num_threads(1)

SOURCE = (cuda.CSRC / "attention.cu").read_text()


def _qkv(B, S, H, KV, hd, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, S, H, hd, generator=g).to(dtype)
    k = torch.randn(B, S, KV, hd, generator=g).to(dtype)
    v = torch.randn(B, S, KV, hd, generator=g).to(dtype)
    return q, k, v


@pytest.mark.parametrize("kind,S", [(FULL, 40), (SLIDING, 40), (CHUNKED, 40),
                                    (CHUNKED, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_take_the_plain_loop_and_launch_nothing(kind, S, dtype):
    cfg = dataclasses.replace(configs.get_smoke_config("qwen3-0.6b"),
                              attn_kind=kind, window=12, chunk=16)
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    q, k, v = _qkv(2, S, H, KV, hd, dtype)
    before = dict(cuda.LAUNCHES)
    got = attention._self_attention(cfg, TP1, q, k, v, kind, q_block=8,
                                    kv_block=8)
    assert dict(cuda.LAUNCHES) == before
    ke = attention._expand_kv(k, H)
    ve = attention._expand_kv(v, H)
    if kind == CHUNKED:  # chunks of 16 folded into the batch, a tail of 8
        n = S // 16
        parts = [attention._flash(
            q[:, :16 * n].reshape(2 * n, 16, H, hd),
            ke[:, :16 * n].reshape(2 * n, 16, H, hd),
            ve[:, :16 * n].reshape(2 * n, 16, H, hd), causal=True,
            window=0, q_block=8, kv_block=8).reshape(2, 16 * n, H, hd)]
        if S > 16 * n:
            parts.append(attention._flash(q[:, 16 * n:], ke[:, 16 * n:],
                                          ve[:, 16 * n:], causal=True,
                                          window=0, q_block=8, kv_block=8))
        want = torch.cat(parts, dim=1)
    else:
        want = attention._flash(q, ke, ve, causal=True,
                                window=12 if kind == SLIDING else 0,
                                q_block=8, kv_block=8)
    assert got.dtype == dtype
    assert torch.equal(got, want)


# (H, KV, tp): GQA 2 and 4, MHA, and head counts that tp pads (7 -> 8,
# 6 -> 8): the padding heads read the last kv head
@pytest.mark.parametrize("H,KV,tp", [(16, 8, 1), (8, 2, 1), (4, 4, 1),
                                     (16, 8, 2), (7, 7, 2), (6, 3, 4),
                                     (8, 2, 2)])
def test_kv_head_map_picks_the_heads_the_plain_path_expands(H, KV, tp):
    cfg = dataclasses.replace(configs.get_smoke_config("qwen3-0.6b"),
                              num_heads=H, num_kv_heads=KV, head_dim=32)
    hl = make_dims(cfg, tp).heads_local
    g = torch.Generator().manual_seed(1)
    k = torch.randn(2, 5, KV, 32, generator=g)
    for rank in range(tp):
        ctx = TPCtx(tp=tp, rank=rank)
        count = hl if tp > 1 else H
        heads = attention._kv_heads(cfg, ctx, count)
        assert heads == attention._kv_index(cfg, rank * hl if tp > 1 else 0,
                                            count)
        assert len(heads) == count and all(0 <= j < KV for j in heads)
        assert torch.equal(attention._take_heads(k, heads),
                           attention._expand(k, cfg, ctx))
    if tp > 1 and hl * tp > H:  # the padding heads sit on the last kv head
        last = attention._kv_heads(cfg, TPCtx(tp=tp, rank=tp - 1), hl)
        assert last[-(hl * tp - H):] == [KV - 1] * (hl * tp - H)


@pytest.mark.parametrize("hd", [80, 256, 48, 8])
def test_check_refuses_head_dims_the_kernels_lack(hd):
    q, k, v = _qkv(1, 8, 4, 2, hd, torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        kattn.check(q, k, v, [0, 0, 1, 1])


@pytest.mark.parametrize("hd", kattn.HEAD_DIMS)
def test_check_takes_the_configs_head_dims(hd):
    q, k, v = _qkv(2, 8, 4, 2, hd, torch.bfloat16)
    kattn.check(q, k, v, [0, 0, 1, 1])
    # a chunked fold's tail: a slice along the sequence, read by strides
    kattn.check(q[:, 3:], k[:, 3:], v[:, 3:], [0, 0, 1, 1])


def test_check_refuses_other_arguments():
    q, k, v = _qkv(1, 8, 4, 2, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        kattn.check(q.double(), k.double(), v.double(), [0, 0, 1, 1])
    with pytest.raises(ValueError, match="kv heads"):
        kattn.check(q, k, v, [0, 1])              # a head short
    with pytest.raises(ValueError, match="kv heads"):
        kattn.check(q, k, v, [0, 0, 1, 2])        # no kv head 2
    with pytest.raises(ValueError, match="does not fit"):
        kattn.check(q, k[:, :4], v[:, :4], [0, 0, 1, 1])
    w = _qkv(1, 8, 4, 2, 128, torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):  # every other lane
        kattn.check(*(t[..., ::2] for t in w), [0, 0, 1, 1])
    with pytest.raises(ValueError, match="CUDA"):
        kattn.attention(q, k, v, [0, 0, 1, 1])


def test_the_source_compiles_what_the_wrapper_allows():
    """attention.cu's head dims and head limit are the wrapper's, and its
    three entry points are the kernels ``cuda.KERNELS`` binds."""
    dims = {int(x) for x in re.findall(r"hd == (\d+)", SOURCE)}
    assert dims == set(kattn.HEAD_DIMS)
    assert int(re.search(r"kMaxHeads = (\d+)", SOURCE).group(1)) == \
        kattn.MAX_HEADS
    names = {k for k, (src, _, _) in cuda.KERNELS.items()
             if src == "attention"}
    assert names == {"attention_fwd", "attention_bwd_dq",
                     "attention_bwd_dkv"}
    assert set(cuda.WIRE_KERNELS).isdisjoint(names)


@pytest.mark.parametrize("kind", [FULL, SLIDING, CHUNKED])
def test_meta_tensors_run_the_kernels_operators(kind):
    """bf16 and float32 meta tensors (the dry run) take the kernels' two
    operators, whose fakes allocate what the card does, and the cost count
    charges the products the kernels run; float64 ones raise, as on the
    card."""
    from repro_torch.launch import op_cost
    cfg = dataclasses.replace(configs.get_config("qwen3-0.6b"),
                              attn_kind=kind, window=24, chunk=16)

    def run(dtype):
        leaves = [torch.empty(2, 40, n, 128, dtype=dtype, device="meta",
                              requires_grad=True) for n in (16, 8, 8)]

        def step(q, k, v):
            out = attention._self_attention(cfg, TP1, q, k, v, kind)
            out.backward(torch.empty_like(out))
        cost = op_cost.analyze_fn(step, *leaves)
        assert [t.grad.shape for t in leaves] == [t.shape for t in leaves]
        return cost

    got = run(torch.bfloat16)
    if kind == CHUNKED:   # chunks of 16 folded into the batch, a tail of 8
        flops = (kattn.product_flops((4, 16, 16, 128), 0)
                 + kattn.product_flops((2, 8, 16, 128), 0))
    else:
        flops = kattn.product_flops((2, 40, 16, 128),
                                    24 if kind == SLIDING else 0)
    assert got.matmul_flops == 9 * flops   # 2 products forward, 7 back
    assert run(torch.float32).matmul_flops == got.matmul_flops
    with pytest.raises(ValueError, match="float32"):
        run(torch.float64)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16])
@pytest.mark.parametrize("kind", [FULL, CHUNKED])
def test_other_dtypes_off_the_cpu_raise_with_no_fall_back(kind, dtype):
    """Off the CPU only the kernels run self-attention: a dtype they lack
    raises ``ValueError`` instead of taking ``_flash``."""
    cfg = dataclasses.replace(configs.get_smoke_config("qwen3-0.6b"),
                              attn_kind=kind, chunk=16)
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    q, k, v = (torch.empty(2, 40, n, hd, dtype=dtype, device="meta")
               for n in (H, KV, KV))
    with pytest.raises(ValueError, match="bfloat16 or all float32"):
        attention._self_attention(cfg, TP1, q, k, v, kind)


def test_check_takes_float32_rows_of_16_bytes():
    q, k, v = _qkv(2, 8, 4, 2, 32)
    kattn.check(q, k, v, [0, 0, 1, 1])
    kattn.check(q[:, 3:], k[:, 3:], v[:, 3:], [0, 0, 1, 1])
    with pytest.raises(ValueError, match="bfloat16 or all float32"):
        kattn.check(q, k.bfloat16(), v, [0, 0, 1, 1])   # mixed dtypes
    # rows 130 floats apart, no whole number of 16-byte pieces: the
    # kernels copy 16-byte pieces
    rows = torch.as_strided(torch.zeros(2 * 8 * 130), (2, 8, 4, 32),
                            (8 * 130, 130, 32, 1))
    with pytest.raises(ValueError, match="16-byte aligned"):
        kattn.check(rows, k, v, [0, 0, 1, 1])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("keep", [False, True])
def test_forward_keeps_a_float32_output_only_for_a_backward(dtype, keep):
    """On the meta device, as on the card: the forward gives o in q's
    dtype and, for a backward, o in float32: a copy beside a bfloat16 o,
    o itself when q is float32."""
    q, k, v = (torch.empty(2, 40, n, 64, dtype=dtype, device="meta")
               for n in (4, 2, 2))
    o, o32, lse = kattn.attention_fwd(q, k, v, [0, 0, 1, 1], 0, keep)
    assert o.dtype == dtype and o.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == (2, 4, 40)
    if not keep:
        assert o32 is None
    elif dtype == torch.float32:
        assert o32 is o
    else:
        assert o32.dtype == torch.float32 and o32.shape == q.shape


@pytest.mark.parametrize("S,window", [(1, 0), (7, 0), (7, 3), (64, 64),
                                      (100, 17)])
def test_product_flops_count_the_pairs_the_mask_admits(S, window):
    q = torch.arange(S)[:, None]
    k = torch.arange(S)[None, :]
    seen = (k <= q) & ((k > q - window) if window > 0 else True)
    assert kattn.product_flops((3, S, 2, 16), window) == \
        2 * 16 * 3 * 2 * int(seen.sum())

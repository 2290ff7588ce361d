"""What the benchmark counts: the wire's bits as the counting transport
sees them, the model FLOPs behind ``mfu``, and the kernels' least bytes."""
import math

import pytest
import torch

from conftest import tiny_cell
from harness import cells, roofline, shapes
from harness.system import Program


@pytest.mark.parametrize("mode", ["fp32", "all_gather", "two_phase"])
def test_counted_wire_bits(mode):
    """32.0 bits a coordinate on the plain wire; on the quantized wires
    the codec plan's bits (all_gather: the plan's; two_phase: the plan's
    sharded reduce direction plus the 8-bit broadcast), in steady steps
    (step 0 also gathers the level update's statistics)."""
    cell = tiny_cell("attn", mode)
    prog = Program(cell.model, cell.traffic, 11, "cpu")
    prog.train_step()
    prog.transport.bytes = 0
    for _ in range(2):
        out = prog.train_step()
    got = prog.transport.bits_per_coord(2, prog.d)
    if mode == "fp32":
        assert got == 32.0
    else:
        assert got == pytest.approx(out["comm_bits_per_coord"], rel=1e-12)
        assert 4.0 < got < (6.0 if mode == "all_gather" else 20.0)


def test_mfu_hand_count():
    """6 N D with N as the dry run counts it: the embedding and the head,
    and per layer attention's projections (RWKV6's time-mix as 6 d^2) and
    the SwiGLU FFN."""
    q = cells.resolve("qwen3-0.6b.alq3-allgather")
    n_q = (2 * 151936 * 1024
           + 28 * (1024 * 2048 + 2 * 1024 * 1024 + 2048 * 1024
                   + 3 * 1024 * 3072))
    assert shapes.param_count(q.model) == n_q == 751_566_848
    assert q.traffic.tokens_per_step == 4 * 8 * 1024
    assert shapes.model_flops(q.model, 32768) == 6 * n_q * 32768
    r = cells.resolve("rwkv6-7b-2l.alq3-allgather")
    n_r = 2 * 65536 * 4096 + 2 * (6 * 4096 ** 2 + 3 * 4096 * 14336)
    assert shapes.param_count(r.model) == n_r == 1_090_519_040
    assert r.traffic.tokens_per_step == 4 * 2 * 1024
    # a 3.9 s step of cell 1 is 3.8% of the bf16 peak
    assert 100 * 6 * n_q * 32768 / 3.9 / 989.4e12 == pytest.approx(3.83,
                                                                   abs=0.01)


def test_kernel_bounds_at_phase_b_shapes():
    """PERF.md's kernel table: quantize (93832, 8192) float32 -> 2.065 ms,
    dequantize_mean (4, 93832, 8192) int8 -> 1.836 ms at 3.35 TB/s."""
    q = roofline.bound_s(roofline.quantize_bytes(93832, 8192, 8))
    assert round(q * 1e3, 3) == 2.065
    dm = roofline.bound_s(roofline.dequantize_mean_bytes(4, 93832, 8192, 8))
    assert round(dm * 1e3, 3) == 1.836
    assert roofline.code_bytes(256) == 2


def test_attention_bounds_at_the_kernels_shape():
    """PERF.md's attention bounds at (8, 1024, 16 heads, 128), causal:
    forward 0.0348 ms, backward 0.0695 ms at 989.4 TFLOP/s; a window
    admits w (w + 1) / 2 + (S - w) w pairs."""
    fwd, bwd = roofline.attention_flops(8, 1024, 16, 128)
    assert fwd == 2 * 8 * 16 * (1024 * 1025 // 2) * 2 * 128 and bwd == 2 * fwd
    assert round(roofline.flops_bound_s(fwd) * 1e3, 4) == 0.0348
    assert round(roofline.flops_bound_s(bwd) * 1e3, 4) == 0.0695
    for S, w in ((64, 16), (64, 64), (64, 0), (5, 9), (1024, 1)):
        assert roofline.attention_pairs(S, w) == sum(
            min(t + 1, w if w > 0 else S) for t in range(S))


def test_wire_buckets_match_the_plan():
    from repro_torch.core.codec import codec_for_scheme
    from repro_torch.core.schemes import QuantScheme
    codec = codec_for_scheme(QuantScheme(bucket_size=8192))
    for d in (751_632_384, 1_058_099_200, 12345):
        assert shapes.wire_buckets(d, 8192) == codec.plan(d).nb
        assert (shapes.wire_buckets(d, 8192, 4)
                == codec.plan(d, shards=4).nb)


def test_uniforms_are_the_seeds():
    a = torch.stack([traffic_u(2 ** 40 + 3, s) for s in (0, 1)])
    b = torch.stack([traffic_u(2 ** 40 + 3, s) for s in (0, 1)])
    assert torch.equal(a, b) and not torch.equal(a[0], a[1])
    assert math.isclose(float(a.mean()), 0.5, abs_tol=0.05)


def traffic_u(seed, step):
    from harness import traffic
    return traffic.uniforms(seed, step, 1, (4, 64), "cpu")

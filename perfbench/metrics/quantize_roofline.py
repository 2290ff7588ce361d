"""The quantize kernel's share of its bandwidth bound in the traced
steps: the least time of its launches (each one's float32 input and
uniforms read once, its codes and norms written once, at the card's HBM
rate) over their device time.  A step launches it once a worker over
the worker's whole gradient, and on the two_phase wire once more a
worker over its shard of the mean, at 8 bits; where the trace holds
another count of launches their shapes are not known, and nothing is
read."""
import re

from harness import roofline, shapes

NAME = re.compile(r"repro::quantize_|5repro\d+quantize_")
TWO_PHASE_BITS = 8


def read(ctx):
    tr = ctx.traffic
    if not tr.quantized or tr.sync_mode not in ("all_gather", "two_phase"):
        return None
    M, bs, bits = tr.workers, tr.scheme["bucket_size"], tr.scheme["bits"]
    shards = M if tr.sync_mode == "two_phase" else 1
    nb = shapes.wire_buckets(ctx.d, bs, shards)
    step = [roofline.quantize_bytes(nb, bs, 2 ** bits)] * M
    if shards > 1:
        step += [roofline.quantize_bytes(nb // M, bs,
                                         2 ** TWO_PHASE_BITS)] * M
    times = [dur for name, _, dur, _ in ctx.kernels if NAME.search(name)]
    if len(times) != ctx.steps * len(step):
        return None
    least = ctx.steps * sum(roofline.bound_s(b, ctx.peak) for b in step)
    return 100.0 * least / (sum(times) * 1e-9)

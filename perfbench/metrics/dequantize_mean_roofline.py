"""The dequantize_mean kernel's share of its bandwidth bound in the
traced steps: the least time of its launches (the M workers' int8 codes
and norms and the level table read once, the float32 mean written once,
at the card's HBM rate) over their device time.  The all_gather wire
decodes and averages the gathered streams in one launch a step, the
two_phase wire each worker's shard of them in one launch a worker; where
the trace holds another count, nothing is read."""
import re

from harness import roofline, shapes

NAME = re.compile(r"repro::mean_|5repro\d+mean_")


def read(ctx):
    tr = ctx.traffic
    if not tr.quantized or tr.sync_mode not in ("all_gather", "two_phase"):
        return None
    M, bs, L = tr.workers, tr.scheme["bucket_size"], 2 ** tr.scheme["bits"]
    shards = M if tr.sync_mode == "two_phase" else 1
    nb = shapes.wire_buckets(ctx.d, bs, shards)
    step = [roofline.dequantize_mean_bytes(M, nb // shards, bs, L)] * shards
    times = [dur for name, _, dur, _ in ctx.kernels if NAME.search(name)]
    if len(times) != ctx.steps * len(step):
        return None
    least = ctx.steps * sum(roofline.bound_s(b, ctx.peak) for b in step)
    return 100.0 * least / (sum(times) * 1e-9)

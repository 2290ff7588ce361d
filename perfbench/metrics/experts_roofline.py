"""The MoE experts' share of the card's dense bfloat16 peak in the
clocked steps: each ``experts`` span's FLOPs, 6 d d_ff for each pair its
``moe`` span counts as kept on this card's experts (``pairs``: the
three products of a pair's SwiGLU, counted on the kept pairs and not on
the padded capacity, so that a dropless or grouped implementation is
judged on the same work), over the span's device time, summed over the
forward and each checkpoint's replay.  None where the program records
no ``experts`` span or counts no ``pairs`` on its ``moe`` span."""
from harness import spans


def read(ctx):
    got = spans.recorded()
    if got is None:
        return None
    before = [s for s in got if s.t0 < ctx.window_ns[0]]
    steps = set(sorted({s.step for s in before})[-ctx.steps:])
    by_id = {s.id: s for s in before}
    per_pair = 6 * ctx.m["d_model"] * ctx.m["d_ff"]
    flops, ms = 0, 0.0
    for s in before:
        if s.step not in steps or s.name != "experts" or s.kind != "span":
            continue
        moe = by_id.get(s.parent)
        if moe is None or "pairs" not in moe.counters:
            return None
        flops += per_pair * moe.counters["pairs"]
        ms += s.ms()
    if not ms:
        return None
    return 100.0 * flops / (ms * 1e-3) / ctx.peak.bf16_flops

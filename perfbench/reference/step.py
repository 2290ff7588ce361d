"""The reference's train steps: what the program's first steps should
have produced, worked out again from the run's seed alone.

Each step: every worker's loss and gradient on its rows (``model``), on
an update step the level update from all workers' gradients, the
aggregate (the quantized mean of ``wire``, or on the plain wire the
float32 mean), and one AdamW update of the float32 parameters with
float32 moments.  The weights, rows and uniforms are the harness's, made
from the seed as the program's were; nothing is taken from the program.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from harness import shapes, traffic as traffic_lib, weights
from . import wire
from .model import Reference

TWO_PHASE_BITS = 8      # the second hop's grid


class Readings(NamedTuple):
    """What a side produced in its first steps: each step's loss (the
    mean over workers), the per-leaf norms of the first aggregate the
    optimizer got, of the parameters' change over the steps, and the
    levels after the first step."""

    losses: list
    grad1: torch.Tensor
    delta: torch.Tensor
    levels: torch.Tensor | None


def leaf_norms(flat: torch.Tensor, leaves) -> torch.Tensor:
    """(leaves,) float64 on the host: each leaf's L2 norm."""
    return torch.stack([
        torch.linalg.vector_norm(flat[lf.offset:lf.offset + lf.numel].float())
        for lf in leaves]).double().cpu()


def leaf_views(flat: torch.Tensor, leaves) -> dict[str, torch.Tensor]:
    return {lf.name: flat[lf.offset:lf.offset + lf.numel].view(lf.shape)
            for lf in leaves}


def adamw(p, g, mu, nu, t, opt):
    """One AdamW step (t from 1) on float32 tensors, in place."""
    b1, b2, eps = opt.get("b1", 0.9), opt.get("b2", 0.95), opt.get("eps", 1e-8)
    mu.mul_(b1).add_((1 - b1) * g)
    nu.mul_(b2).add_((1 - b2) * g * g)
    c1, c2 = 1 - b1 ** t, 1 - b2 ** t
    upd = (mu / c1) / (torch.sqrt(nu / c2) + eps)
    p.sub_(opt["lr"] * (upd + opt.get("weight_decay", 0.0) * p))


def follow(m: dict, tr: traffic_lib.Traffic, seed: int, steps: int, device,
           fp8: bool = False) -> Readings:
    """The reference's first ``steps`` steps of seed ``seed``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    leaves = shapes.leaves(m)
    ref = Reference(m, fp8=fp8)
    p = weights.make(m, seed, device)
    p0 = p.clone()
    mu, nu = torch.zeros_like(p), torch.zeros_like(p)
    d = p.numel()
    bs = tr.scheme["bucket_size"]
    M = tr.workers
    two_phase = tr.sync_mode == "two_phase"
    nb = shapes.wire_buckets(d, bs, M if two_phase else 1)
    levels = (wire.uniform_levels(tr.scheme["bits"], device)
              if tr.quantized else None)
    if tr.compress not in ("plain", "ef") and not tr.compress.startswith(
            "ef:"):
        raise ValueError(f"compression {tr.compress!r}")
    ef_from = (int(tr.compress.partition(":")[2] or 0)
               if tr.compress.startswith("ef") else None)
    resid = ([torch.zeros_like(p) for _ in range(M)]
             if ef_from is not None else None)
    losses, grad1 = [], None
    for t in range(steps):
        batch = traffic_lib.rows(tr, m["vocab_size"], seed, t, device)
        grads, loss = [], 0.0
        for w in range(tr.workers):
            rows = slice(w * tr.rows_per_worker, (w + 1) * tr.rows_per_worker)
            pw = p.detach().requires_grad_()
            lw = ref.loss(leaf_views(pw, leaves), batch["ids"][rows],
                          batch["labels"][rows])
            lw.backward()
            grads.append(pw.grad)
            loss = loss + lw.item()
            del pw, lw
        losses.append(loss / tr.workers)
        if not tr.quantized:
            agg = grads[0].clone()
            for g in grads[1:]:
                agg += g
            agg /= tr.workers
        else:
            if tr.is_update_step(t):
                levels = wire.update_levels(levels, grads, bs)
            fed = resid if ef_from is not None and t >= ef_from else None
            if fed is not None:
                for g, e in zip(grads, fed):
                    g += e
            agg = wire.quantized_mean(
                grads, levels,
                lambda w: traffic_lib.uniforms(seed, t, w, (nb, bs), device,
                                               1),
                bs, nb, fed)
            if two_phase:
                agg = wire.requantized(
                    agg, lambda r: traffic_lib.uniforms(
                        seed, t, r, (nb // M, bs), device, 2),
                    M, TWO_PHASE_BITS)
            agg = agg.view(-1)[:d]
        del grads
        if t == 0:
            grad1 = leaf_norms(agg, leaves)
            levels1 = None if levels is None else levels.cpu()
        with torch.no_grad():
            adamw(p, agg, mu, nu, t + 1, tr.optimizer)
        del agg
    delta = leaf_norms(p - p0, leaves)
    return Readings(losses, grad1, delta, levels1)

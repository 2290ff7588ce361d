"""The weights of a run, made from its seed on the device.

One normal draw fills the whole flat vector, and each leaf is then, in
flat order, scaled by its fan-in or set to ones or zeros in place, or
drawn by its layer kind's own draw (``layers.DRAWS``; RWKV6's time-mix
draws three of its leaves as a trained model holds them), which may use
the same generator.

Both sides get these weights: the program has them copied into its flat
buffer, the reference makes them again from the same seed.
"""
from __future__ import annotations

import numpy as np
import torch

import layers

from . import shapes

_WEIGHTS = 0x3E16


def derive(seed: int, *path: int) -> int:
    """A 63-bit generator seed for (seed, *path)."""
    ss = np.random.SeedSequence([seed, *path])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


@torch.no_grad()
def fill(flat: torch.Tensor, m: dict, seed: int) -> torch.Tensor:
    """Write the weights of seed ``seed`` for the configuration ``m``
    into ``flat`` (d,) and return it."""
    gen = torch.Generator(device=flat.device).manual_seed(
        derive(seed, _WEIGHTS))
    flat.normal_(generator=gen)
    for leaf in shapes.leaves(m):
        view = flat[leaf.offset:leaf.offset + leaf.numel]
        if leaf.draw == shapes.NORMAL:
            view.mul_(leaf.fan_in ** -0.5)
        elif leaf.draw == shapes.ONES:
            view.fill_(1.0)
        elif leaf.draw == shapes.ZEROS:
            view.zero_()
        elif leaf.draw in layers.DRAWS:
            layers.DRAWS[leaf.draw](view, gen, leaf.fan_in)
        else:
            raise ValueError(leaf.draw)
    return flat


def make(m: dict, seed: int, device, dtype=torch.float32) -> torch.Tensor:
    flat = torch.empty(shapes.coordinates(m), dtype=dtype, device=device)
    return fill(flat, m, seed)

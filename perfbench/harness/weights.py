"""The weights of a run, made from its seed on the device.

One normal draw fills the whole flat vector, each leaf is then scaled by
its fan-in (or set to ones or zeros) in place, and RWKV6's time-mix
leaves that a trained model holds away from their init get one uniform
draw each: token-shift mixes in [0, 1], the decay base w0 in [-4, -0.5],
the decay LoRA's B at a fifth of its scale.  With the init's zero mixes
and w0 the log decays of random tokens reach tens a token, the chunked
``exp`` of the time-mix overflows, and the gradient holds NaN; with these
they stay within about -0.01 to -1 a token.

Both sides get these weights: the program has them copied into its flat
buffer, the reference makes them again from the same seed.
"""
from __future__ import annotations

import numpy as np
import torch

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
        elif leaf.draw == shapes.MIX:
            view.uniform_(0.0, 1.0, generator=gen)
        elif leaf.draw == shapes.DECAY_BASE:
            view.uniform_(-4.0, -0.5, generator=gen)
        elif leaf.draw == shapes.DECAY_LORA_B:
            view.mul_(0.2 * leaf.fan_in ** -0.5)
        else:
            raise ValueError(leaf.draw)
    return flat


def make(m: dict, seed: int, device, dtype=torch.float32) -> torch.Tensor:
    flat = torch.empty(shapes.coordinates(m), dtype=dtype, device=device)
    return fill(flat, m, seed)

"""What the benchmark works out from a configuration's numbers alone: its
layer slots and the kind (``layers/``) that is each slot's mixer and
FFN, the parameter leaves in the order of the flat vector that the
trainer updates, how each leaf is drawn, the coordinate count d, the
parameter counts that model FLOPs are taken from, and the wire's bucket
layout.

The flat order is the reference package's ``ravel_pytree`` order, which
the port keeps: ``embed`` (1, V, d), ``final_norm`` (d,), ``lm_head``
(1, d, V), then for each of the ``group_size`` slots of a group its
leaves with their paths sorted (``norm1``, ``norm2``, the mixer's as
``mixer.*``, the FFN's as ``ffn.*``), every leaf stacked over the
``num_layers // group_size`` groups as (groups, 1, ...).  ``group_size``
is the lcm of the kinds' periods.

Resolution fails closed: a slot that no kind, or two, take is refused,
and so is a ``model`` key that neither the stack nor a kind that takes a
slot reads.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import layers

# how a leaf is drawn: normal * fan_in ** -0.5, ones, zeros, or a draw of
# its kind's own (``layers.DRAWS``)
NORMAL, ONES, ZEROS = layers.BASE_DRAWS

BUCKET_TILE = 8     # the wire pads its bucket count to a multiple of this
# the keys the stack reads: the port's fields that every configuration
# names (the head counts too, which a recurrent mixer does not use), the
# norms' epsilon and the dtypes
STACK_KEYS = frozenset({
    "name", "arch_type", "num_layers", "d_model", "num_heads",
    "num_kv_heads", "vocab_size", "norm_eps", "compute_dtype",
    "param_dtype"})


class Leaf(NamedTuple):
    name: str
    shape: tuple
    offset: int
    draw: str
    fan_in: int = 0

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


class Slot(NamedTuple):
    """The kinds of one layer slot."""

    mixer: object
    ffn: object


def group_size(m: dict) -> int:
    return math.lcm(*(k.period(m) for k in layers.KINDS
                      if hasattr(k, "period")), 1)


def _taker(m: dict, slot: int, role: str):
    kinds = [k for k in layers.KINDS if k.ROLE == role and k.takes(m, slot)]
    own = [k for k in kinds if not getattr(k, "DEFAULT", False)]
    pick = own or kinds
    if len(pick) != 1:
        raise ValueError(
            f"{m['name']}: the {role} of slot {slot} is taken by "
            f"{[layers.name(k) for k in pick] or 'no layer kind'}")
    return pick[0]


def slots(m: dict) -> list[Slot]:
    """Each slot of a group of the configuration ``m`` (the numbers of
    its ``model`` entry), with its mixer's and its FFN's kinds."""
    G = group_size(m)
    if m["num_layers"] % G:
        raise ValueError(f"{m['name']}: {m['num_layers']} layers in groups "
                         f"of {G}")
    out = [Slot(_taker(m, j, "mixer"), _taker(m, j, "ffn"))
           for j in range(G)]
    read = STACK_KEYS.union(*(k.KEYS for s in out for k in s))
    unread = sorted(set(m) - read)
    if unread:
        raise ValueError(f"{m['name']}: no layer kind that takes a slot "
                         f"reads {unread}")
    return out


def _slot_leaves(m: dict, slot: int, kinds: Slot
                ) -> dict[str, tuple[tuple, str, int]]:
    """A slot's leaves: path -> (per-layer shape, draw, fan_in)."""
    d = m["d_model"]
    out = {"norm1": ((d,), ONES, 0), "norm2": ((d,), ONES, 0)}
    for role, kind in zip(layers.ROLES, kinds):
        out.update({f"{role}.{p}": v
                    for p, v in kind.leaves(m, slot).items()})
    return out


def leaves(m: dict) -> list[Leaf]:
    """Every parameter leaf of the configuration ``m``, in flat order,
    with its offset."""
    d, V = m["d_model"], m["vocab_size"]
    kinds = slots(m)
    G = m["num_layers"] // len(kinds)
    top = [("embed", (1, V, d), NORMAL, d), ("final_norm", (d,), ONES, 0),
           ("lm_head", (1, d, V), NORMAL, d)]
    for j, slot in enumerate(kinds):
        sl = _slot_leaves(m, j, slot)
        top += [(f"slots.{j}.{p}", (G, 1, *sl[p][0]), *sl[p][1:])
                for p in sorted(sl, key=lambda p: p.split("."))]
    out, off = [], 0
    for name, shape, draw, fan_in in top:
        leaf = Leaf(name, shape, off, draw, fan_in)
        out.append(leaf)
        off += leaf.numel
    return out


def coordinates(m: dict) -> int:
    """d: the length of the flat parameter vector, and of a gradient."""
    last = leaves(m)[-1]
    return last.offset + last.numel


def param_count(m: dict) -> int:
    """The parameters a token touches, as the dry run counts them for
    model FLOPs: the embedding and the head, and each layer's mixer and
    FFN as their kinds count them (``active``), without norms."""
    kinds = slots(m)
    G = m["num_layers"] // len(kinds)
    return 2 * m["vocab_size"] * m["d_model"] + G * sum(
        k.active(m, j) for j, s in enumerate(kinds) for k in s)


def model_flops(m: dict, tokens: int) -> float:
    """Training's model FLOPs, 6 N D, N the parameters a token touches."""
    return 6.0 * param_count(m) * tokens


def wire_buckets(d: int, bucket_size: int, shards: int = 1) -> int:
    """The bucket count a worker's payload is laid out in: d's buckets,
    padded to a multiple of ``BUCKET_TILE`` times the shards."""
    nb = -(-d // bucket_size)
    m = BUCKET_TILE * shards
    return -(-nb // m) * m

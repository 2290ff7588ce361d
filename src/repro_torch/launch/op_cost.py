"""Analytic per-rank cost of a step, counted op by op on the meta device
(the dry run's roofline input; the counterpart of the reference's
``launch/jaxpr_cost.py``).

``analyze_fn(fn, *args)`` runs ``fn`` under ``CostMode``, a
``TorchDispatchMode`` that sees every ATen operator the step issues,
forward and backward, with the shapes one rank holds.  On meta tensors
nothing is computed and nothing is allocated; the rules are the
reference's:

  * ``flops``: 2 * out * k for the matmuls (``mm``, ``bmm``, ``addmm``,
    ``baddbmm``; ``matmul``, ``linear`` and ``einsum`` reach the
    dispatcher as these), 2 * out * (the kernel's elements an output
    channel) for ``convolution``, the reference's conv rule; plus 1 a
    result element for the pointwise operators (ATen's ``pointwise``
    tag: arithmetic, comparisons, ``where``, the activations, and
    ``cumsum``; not ``clone`` or a cast, which copy) and 1 an input
    element for the reductions (``REDUCE_OPS``).  ``matmul_flops`` keeps
    the matmul and convolution part on its own.
  * ``hbm_bytes``: operands plus results of the "major" operators, the
    counterparts of the reference's ``MAJOR_BYTES_PRIMS``: the matmuls
    and convolution, gathers and scatters, sorts, ``cumsum`` and the
    reductions (``MAJOR_OPS``), and each bucket kernel
    (``repro_torch::quantize``, ``dequantize``, ``dequantize_mean``,
    ``bucket_stats``) as the one operator it is on the card, charged what
    its bound counts.
    Elementwise chains are taken as fused into them, as the reference
    takes them (an estimate of fused traffic, not an upper bound).
  * ``collective_bytes``, by kind in ``by_collective``: each
    ``torch.distributed`` collective (the ``c10d`` operators a process
    group issues) and the model group's ``repro_torch::tp_all_reduce``,
    weighted as the reference weighs its primitives (an all-reduce 2,
    for its ring's reduce-scatter and all-gather; an all-gather, an
    all-to-all, a reduce-scatter and a broadcast 1) times the payload,
    max(in, out).
  * ``peak_bytes``: the high-water mark of live storages, those of the
    tensors in ``args`` (which stay live) and every one an operator
    allocates, released when its last tensor dies; a view shares its
    base's storage.  The counterpart of XLA's ``memory_analysis``
    (argument + temp).

Eager Python runs every loop iteration, so the layer loop, the chunked
loss, a ``--micro`` split and FSDP's rounds are counted as often as they
run (the reference multiplies a ``scan`` body by its trip count); a
checkpoint's replay in the backward is counted as the reference counts
its ``checkpoint`` bodies.  All numbers are one rank's.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

MATMUL_OPS = {aten.mm, aten.bmm, aten.addmm, aten.baddbmm}
CONV_OPS = {aten.convolution}
REDUCE_OPS = {
    aten.sum, aten.mean, aten.amax, aten.amin, aten.max, aten.min,
    aten.prod, aten.argmax, aten.argmin, aten.any, aten.all,
    aten.logsumexp, aten.linalg_vector_norm, aten.norm, aten.var,
    aten.std, aten.var_mean, aten._softmax, aten._log_softmax,
}
GATHER_SCATTER_OPS = {
    aten.index, aten.index_select, aten.gather, aten.embedding,
    aten.take_along_dim, aten.scatter, aten.scatter_add,
    aten.scatter_reduce, aten.index_put, aten._index_put_impl_,
    aten.index_add, aten.index_copy, aten.slice_scatter,
    aten.select_scatter, aten.sort, aten.topk, aten.cumsum,
}
# in-place writers of values besides the pointwise ones
VALUE_WRITES = {aten.copy_, aten.fill_, aten.zero_, aten.index_put_,
                aten.masked_fill_, aten.clamp_}
# the bucket kernels, charged operands + results as their bounds are
KERNEL_OPS = ("quantize", "dequantize", "dequantize_mean", "bucket_stats")
MAJOR_OPS = MATMUL_OPS | CONV_OPS | REDUCE_OPS | GATHER_SCATTER_OPS
# c10d operator -> (kind, wire weight)
COLLECTIVES = {
    "allreduce_": ("all_reduce", 2.0),
    "allgather_": ("all_gather", 1.0),
    "_allgather_base_": ("all_gather", 1.0),
    "allgather_into_tensor_coalesced_": ("all_gather", 1.0),
    "alltoall_": ("all_to_all", 1.0),
    "alltoall_base_": ("all_to_all", 1.0),
    "reduce_scatter_": ("reduce_scatter", 1.0),
    "_reduce_scatter_base_": ("reduce_scatter", 1.0),
    "broadcast_": ("broadcast", 1.0),
}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    by_collective: dict = dataclasses.field(default_factory=dict)
    matmul_flops: float = 0.0
    peak_bytes: int = 0


def _tensors(x) -> list[torch.Tensor]:
    """The tensors in x: a tensor, or lists, tuples and dicts of them."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    if isinstance(x, dict):
        return [t for y in x.values() for t in _tensors(y)]
    return []


def nbytes(x) -> int:
    """The bytes of the tensors in x."""
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _matmul_flops(packet, args, out) -> float:
    if packet in CONV_OPS:
        w = args[1]              # (C_out, C_in / groups, *kernel)
        return 2.0 * out.numel() * math.prod(w.shape[1:])
    a = args[1] if packet in (aten.addmm, aten.baddbmm) else args[0]
    return 2.0 * out.numel() * a.shape[-1]


class _Unhashable(Exception):
    pass


def _sig(x):
    """A hashable stand-in for an argument: a meta tensor's shape,
    strides and dtype, or the value itself."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise _Unhashable
        return (x.shape, x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_sig(y) for y in x)
    if x is None or isinstance(x, (bool, int, float, str, torch.dtype,
                                   torch.device, torch.memory_format,
                                   torch.layout)):
        return (type(x), x)
    raise _Unhashable


def _writes_self_values(func) -> bool:
    """An in-place operator that writes its first argument's values alone
    (``mul_``, ``copy_``), not its shape (``resize_``, ``unsqueeze_``)."""
    writes = [a.alias_info is not None and a.alias_info.is_write
              for a in func._schema.arguments]
    return (bool(writes) and writes[0] and not any(writes[1:])
            and (torch.Tag.pointwise in func.tags
                 or func.overloadpacket in VALUE_WRITES))


class CostMode(TorchDispatchMode):
    """Counts ``cost`` (see the module's docstring) of every operator run
    under it; ``pinned`` tensors' storages are live from the start and
    never released.

    Many of torch's meta kernels are written in Python and cost 0.1-0.3
    ms a call, so the outputs' shapes, strides and dtypes of an ATen
    operator are remembered by its inputs' and reused when they recur
    (a layer's, a block's): a result that is computed from its inputs'
    metadata alone, which is all a meta kernel reads.  Torch's own
    ``FakeTensorMode`` dispatch cache cannot serve instead: on
    llama3.2-1b's train_4k step it gives the same counts at 97% cache
    hits, but its own Python work an operator costs more than the meta
    kernels it skips (``experiments/op_cost_memo.py`` on one CPU thread:
    44.1 s under it, 27.2 s with no memo, 9.9 s with this one).
    Operators under inference mode reach the mode before ATen decomposes
    them (``matmul``, ``einsum``), so it decomposes those that have no
    kernel of their own itself; ``silu_backward``, which has one, stays
    one operator with one output, as it is one launch on the card."""

    def __init__(self, pinned=()):
        super().__init__()
        self._live: dict[int, list] = {}     # storage -> [bytes, tensors]
        self._ids: set[int] = set()          # tensors tracked, by id
        self._shapes: dict = {}              # (op, inputs) -> outputs
        self._rules: dict = {}
        self.live_bytes = 0
        for t in _tensors(pinned):
            k = _key(t)
            if k not in self._live:
                n = t.untyped_storage().nbytes()
                self._live[k] = [n, math.inf]
                self.live_bytes += n
        self.reset()

    def reset(self) -> None:
        """Count from here: a new ``cost`` whose peak starts at the bytes
        live now."""
        self.cost = Cost(peak_bytes=self.live_bytes)
        self._at_reset = set(self._live)

    def new_bytes(self, x) -> int:
        """The bytes of the storages of ``x``'s tensors allocated since
        the last ``reset``."""
        keys = {_key(t) for t in _tensors(x)}
        return sum(self._live[k][0] for k in keys
                   if k in self._live and k not in self._at_reset)

    def _release(self, tid: int, key: int) -> None:
        self._ids.discard(tid)
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            del self._live[key]
            self.live_bytes -= entry[0]

    def _track(self, outs: list[torch.Tensor], ins) -> None:
        in_keys = None
        for t in outs:
            if id(t) in self._ids:
                continue
            k = _key(t)
            entry = self._live.get(k)
            if entry is None:
                if in_keys is None:
                    in_keys = {_key(x) for x in _tensors(ins)}
                if k in in_keys:       # a view of memory not counted here
                    continue
                entry = self._live[k] = [t.untyped_storage().nbytes(), 0]
                self.live_bytes += entry[0]
            entry[1] += 1
            self._ids.add(id(t))
            weakref.finalize(t, self._release, id(t), k)
        self.cost.peak_bytes = max(self.cost.peak_bytes, self.live_bytes)

    def _run(self, func, args, kwargs):
        """func(*args, **kwargs), from remembered output metadata where
        the same inputs' were seen before."""
        if func.namespace != "aten" or func.is_view:
            return func(*args, **kwargs)
        try:
            sig = (func, _sig(args), _sig(tuple(kwargs.items())))
        except _Unhashable:
            return func(*args, **kwargs)
        known = self._shapes.get(sig)
        if known == "self":
            return args[0]
        if known is not None:
            outs = [torch.empty_strided(shape, stride, dtype=dtype,
                                        device="meta")
                    for shape, stride, dtype in known[1]]
            return tuple(outs) if known[0] else outs[0]
        out = func(*args, **kwargs)
        if func._schema.is_mutable:
            if out is args[0] and _writes_self_values(func):
                self._shapes[sig] = "self"
            return out
        outs = list(out) if isinstance(out, tuple) else [out]
        if not all(isinstance(t, torch.Tensor) and t.device.type == "meta"
                   for t in outs):
            return out
        in_keys = {_key(t) for t in _tensors((args, kwargs))}
        if any(_key(t) in in_keys for t in outs):
            return out
        self._shapes[sig] = (isinstance(out, tuple), [
            (t.shape, t.stride(), t.dtype) for t in outs])
        return out

    def _rule(self, func):
        """How ``func`` is counted: (decompose it, flop rule, wire kind
        and weight, charged HBM bytes)."""
        packet = func.overloadpacket
        ns, name = func.namespace, packet.__name__
        if packet in MATMUL_OPS or packet in CONV_OPS:
            flops = "matmul"
        elif (torch.Tag.pointwise in func.tags and packet is not aten.clone
              or packet is aten.cumsum):
            flops = "out"
        elif packet in REDUCE_OPS:
            flops = "in"
        else:
            flops = None
        wire = None
        if ns == "c10d" and name in COLLECTIVES:
            wire = COLLECTIVES[name]
        elif ns == "repro_torch" and name == "tp_all_reduce":
            wire = ("all_reduce", 2.0)
        major = wire is None and (packet in MAJOR_OPS or (
            ns == "repro_torch" and name in KERNEL_OPS))
        # an operator with a kernel of its own (``silu_backward``) is one
        # launch on the card; only one with none (``matmul`` under
        # inference mode) is decomposed, as the card decomposes it
        has = functools.partial(
            torch._C._dispatch_has_kernel_for_dispatch_key, func.name())
        decompose = has("CompositeImplicitAutograd") and not any(
            has(k) for k in ("CPU", "CUDA", "Meta"))
        rule = self._rules[func] = (decompose, flops, wire, major)
        return rule

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        rule = self._rules.get(func) or self._rule(func)
        decompose, flops, wire, major = rule
        if decompose:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = self._run(func, args, kwargs)
        outs = _tensors(out)
        if not any(t.device.type == "meta" for t in outs):
            return out          # the host's own work (index arithmetic)
        c = self.cost
        if flops == "matmul":
            f = _matmul_flops(func.overloadpacket, args, out)
            c.flops += f
            c.matmul_flops += f
        elif flops == "out":
            c.flops += sum(t.numel() for t in outs)
        elif flops == "in":
            c.flops += args[0].numel()
        if wire is not None:
            kind, weight = wire
            payload = max(nbytes(args[0]), nbytes(args[1:2]))
            c.collective_bytes += payload * weight
            c.by_collective[kind] = (c.by_collective.get(kind, 0.0)
                                     + payload * weight)
        elif major:
            c.hbm_bytes += (nbytes((args, kwargs))
                            + sum(t.numel() * t.element_size() for t in outs))
        self._track(outs, (args, kwargs))
        return out


def analyze_fn(fn, *args) -> Cost:
    """One rank's cost of ``fn(*args)`` (on meta tensors: shapes only).
    ``args``' tensors count as live throughout."""
    with CostMode(pinned=args) as mode:
        fn(*args)
    return mode.cost

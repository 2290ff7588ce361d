"""CUDA kernels: causal self-attention on the bf16 tensor cores, forward
and backward.

They replace no TPU kernel: the reference's attention is a blockwise loop
in plain jnp (``repro/models/attention.py::_flash``), and the port's
plain version, ``models/attention.py::_flash``, is the same loop in
PyTorch, in float32.  On the card that loop ran every score and product
on the CUDA cores; these kernels (``csrc/attention.cu``) do the same
work on the tensor cores, keeping in float32 everything the loop keeps
in float32 (P and dS, and q, k, v and dO when they are float32, enter
their products as three bf16 terms).

``attention(q, k, v, heads, window)`` is the model's operator, an
``autograd.Function``: q (B, S, H, hd) and k, v (B, S, KV, hd), all
bfloat16 or all float32, read by their strides with no expanded copy;
``heads`` gives the kv head of each q head
(``models/attention.py::_kv_heads``); causal, with a sliding ``window``
when it is > 0.  Anything else raises ``ValueError``: there is no other
route on the card.  Its forward is one launch (``attention_fwd``), its
backward two (``attention_bwd_dq``, then ``attention_bwd_dkv``), each
counted in ``cuda.LAUNCHES`` and on the recorder's ``launches`` counter.
The backward adds nothing across blocks, so two passes give the same
bits.

On the meta device the forward and the backward are each one operator
(``repro_torch::attention_fwd``, ``repro_torch::attention_bwd``) whose
fake gives the outputs the card allocates, so that the dry run
(``launch.op_cost``) holds the card's memory and counts the products the
kernels run (``product_flops``: 2 of them forward, 7 backward, whose two
kernels each recompute S and dP).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import timing
from . import cuda

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.bfloat16, torch.float32)
MAX_HEADS = 256   # csrc/attention.cu's kMaxHeads
# the (S x S, causal) products each kernel call runs
PRODUCTS = {"attention_fwd": 2, "attention_bwd": 7}


def check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          heads) -> None:
    """Raise ``ValueError`` on what the kernels do not take."""
    cuda.check(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape,
               f"attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
               f"v {tuple(v.shape)} must be (B, S, heads, head_dim)")
    B, S, H, hd = q.shape
    cuda.check(k.shape[0] == B and k.shape[1] == S and k.shape[3] == hd,
               f"attention: k {tuple(k.shape)} does not fit q "
               f"{tuple(q.shape)}")
    cuda.check(hd in HEAD_DIMS,
               f"attention: head_dim {hd} not one of {HEAD_DIMS}")
    cuda.check(q.dtype == k.dtype == v.dtype and q.dtype in DTYPES,
               f"attention: q, k and v must all be bfloat16 or all float32, "
               f"not {q.dtype}, {k.dtype}, {v.dtype}")
    cuda.check(len(heads) == H <= MAX_HEADS
               and all(0 <= j < k.shape[2] for j in heads),
               f"attention: {len(heads)} kv heads for {H} q heads, of "
               f"{k.shape[2]}")
    per = 16 // q.element_size()   # elements of 16 bytes
    for name, t in (("q", q), ("k", k), ("v", v)):
        cuda.check(t.stride(3) == 1 and t.data_ptr() % 16 == 0
                   and all(s % per == 0 for s in t.stride()[:3]),
                   f"attention: {name}'s head dim must be contiguous, its "
                   "rows 16-byte aligned")


def kv_map(heads) -> ctypes.Array:
    """``heads`` as a host array of int32, which the C entry points copy
    into the kernels' arguments: no device memory, no copy."""
    return (ctypes.c_int * len(heads))(*heads)


def product_flops(q_shape, window: int) -> float:
    """FLOPs of one causal product over q (B, S, H, hd): 2 hd for every
    (query, key) pair the window admits (all earlier keys when it is
    <= 0), over B and H."""
    B, S, H, hd = q_shape
    w = S if window <= 0 else min(window, S)
    pairs = w * (w + 1) // 2 + (S - w) * w
    return 2.0 * hd * pairs * B * H


def _strides(*ts: torch.Tensor) -> list[int]:
    return [s for t in ts for s in t.stride()[:3]]


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  heads, window: int, keep: bool
                  ) -> tuple[torch.Tensor, torch.Tensor | None,
                             torch.Tensor]:
    """(o (B, S, H, hd) in q's dtype, o in float32 for a backward if
    ``keep`` else None, lse (B, H, S) float32): each row's log-sum-exp in
    base 2 of the scaled scores.  The float32 o is a copy the kernel
    writes beside a bfloat16 o, and o itself when q is float32."""
    check(q, k, v, heads)
    wide = keep and q.dtype != torch.float32
    if q.device.type == "meta":
        o, o32, lse = attention_fwd_meta(q, k, v, list(heads), window, wide)
    else:
        o, o32, lse = _fwd(q, k, v, heads, window, wide)
    return o, (o32 if wide else o) if keep else None, lse


def _fwd(q, k, v, heads, window, wide):
    B, S, H, hd = q.shape
    dev = q.device
    o = torch.empty((B, S, H, hd), dtype=q.dtype, device=dev)
    o32 = (torch.empty((B, S, H, hd), dtype=torch.float32, device=dev)
           if wide else None)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    timing.count("launches")
    cuda.launch("attention_fwd", dev, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), kv_map(heads), o.data_ptr(),
                None if o32 is None else o32.data_ptr(), lse.data_ptr(),
                *_strides(q, k, v), B, S, H, k.shape[2], hd, window,
                cuda.IN_CODES[q.dtype])
    return o, o32, lse


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  heads, window: int, o32: torch.Tensor, lse: torch.Tensor,
                  dout: torch.Tensor, grad_dtype: torch.dtype | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in q's dtype from the forward's float32 ``o32`` and
    ``lse`` and the output's gradient ``dout``: ``bwd_dq``, then
    ``bwd_dkv``.  ``grad_dtype`` float32 for bfloat16 inputs is for the
    precision tests alone, which read the gradients' float32 sums before
    their last rounding; the model never passes it."""
    check(q, k, v, heads)
    if q.device.type == "meta":
        return attention_bwd_meta(q, k, v, list(heads), window, o32, lse,
                                  dout)
    dout = dout.to(q.dtype).contiguous()
    dq, delta = bwd_dq(q, k, v, heads, window, o32, lse, dout, grad_dtype)
    dk, dv = bwd_dkv(q, k, v, heads, window, lse, delta, dout, grad_dtype)
    return dq, dk, dv


def _types(q, grad_dtype) -> tuple[int, int]:
    grad_dtype = grad_dtype or q.dtype
    cuda.check(grad_dtype in cuda.IN_CODES
               and (q.dtype, grad_dtype) != (torch.float32, torch.bfloat16),
               f"attention: gradients in {grad_dtype} from {q.dtype}")
    return cuda.IN_CODES[q.dtype], cuda.IN_CODES[grad_dtype]


def bwd_dq(q, k, v, heads, window: int, o32, lse, dout, grad_dtype=None
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward's first launch: (dq, D (B, H, S) float32 = rowsum(dout
    * o32)), ``dout`` contiguous in q's dtype."""
    B, S, H, hd = q.shape
    cuda.check(o32.dtype == torch.float32 and o32.shape == q.shape
               and o32.is_contiguous() and lse.shape == (B, H, S)
               and dout.dtype == q.dtype and dout.shape == q.shape
               and dout.is_contiguous(), "attention: o32, lse or dout")
    codes = _types(q, grad_dtype)
    dq = torch.empty(q.shape, dtype=grad_dtype or q.dtype, device=q.device)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    timing.count("launches")
    cuda.launch("attention_bwd_dq", q.device, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), kv_map(heads), o32.data_ptr(), lse.data_ptr(),
                dout.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                *_strides(q, k, v), B, S, H, k.shape[2], hd, window, *codes)
    return dq, delta


def bwd_dkv(q, k, v, heads, window: int, lse, delta, dout, grad_dtype=None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward's second launch, after ``bwd_dq``: (dk, dv)."""
    B, S, H, hd = q.shape
    codes = _types(q, grad_dtype)
    dk = torch.empty(k.shape, dtype=grad_dtype or q.dtype, device=q.device)
    dv = torch.empty(k.shape, dtype=grad_dtype or q.dtype, device=q.device)
    timing.count("launches")
    cuda.launch("attention_bwd_dkv", q.device, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), kv_map(heads), lse.data_ptr(), delta.data_ptr(),
                dout.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                *_strides(q, k, v), B, S, H, k.shape[2], hd, window, *codes)
    return dk, dv


@torch.library.custom_op("repro_torch::attention_fwd", mutates_args=())
def attention_fwd_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       heads: list[int], window: int, wide: bool
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward launch as one operator (o32 empty unless ``wide``); on
    meta tensors its fake runs."""
    o, o32, lse = _fwd(q, k, v, heads, window, wide)
    return o, o32 if wide else lse.new_empty(0), lse


@attention_fwd_meta.register_fake
def _(q, k, v, heads, window, wide):
    check(q, k, v, heads)
    B, S, H, _ = q.shape
    o32 = q.new_empty(q.shape if wide else (0,), dtype=torch.float32)
    return q.new_empty(q.shape), o32, q.new_empty((B, H, S),
                                                  dtype=torch.float32)


@torch.library.custom_op("repro_torch::attention_bwd", mutates_args=())
def attention_bwd_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       heads: list[int], window: int, o32: torch.Tensor,
                       lse: torch.Tensor, dout: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``attention_bwd`` as one operator; on meta tensors its fake runs."""
    return attention_bwd(q, k, v, heads, window, o32, lse, dout)


@attention_bwd_meta.register_fake
def _(q, k, v, heads, window, o32, lse, dout):
    check(q, k, v, heads)
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


class _Attention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, heads, window, keep):
        o, o32, lse = attention_fwd(q, k, v, heads, window, keep)
        if keep:
            ctx.save_for_backward(q, k, v, o32, lse)
            ctx.heads, ctx.window = heads, window
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, o32, lse = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, ctx.heads, ctx.window, o32, lse,
                                   dout)
        return dq, dk, dv, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads,
              window: int = 0) -> torch.Tensor:
    """Causal attention of q (B, S, H, hd) over k, v (B, S, KV, hd), q head
    h reading kv head ``heads[h]``, keys older than ``window`` hidden when
    it is > 0: (B, S, H, hd) in q's dtype (bfloat16 or float32), by the
    CUDA kernels (on meta tensors, their operators)."""
    cuda.check(q.device.type in ("cuda", "meta"),
               "attention: q must lie on a CUDA (or the meta) device")
    # the float32 output and the log-sum-exp are kept only for a backward
    keep = torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v))
    return _Attention.apply(q, k, v, tuple(heads), window, keep)

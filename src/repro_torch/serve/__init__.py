"""Serving: batched prefill and greedy decode against ring-addressed KV
caches and recurrent states."""
from .engine import ServeConfig, make_decode_step, make_prefill_step

__all__ = ["ServeConfig", "make_decode_step", "make_prefill_step"]

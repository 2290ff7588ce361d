"""Quantized gradient synchronization over M workers."""

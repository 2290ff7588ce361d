"""Quantizer core: levels, statistics, adaptation, packing and the codec."""

"""PyTorch and CUDA port of the adaptive gradient quantization system.

It mirrors the JAX package ``repro`` module by module and imports
nothing of it.  Entry points run on the CUDA device unless the caller
passes ``device="cpu"``.
"""

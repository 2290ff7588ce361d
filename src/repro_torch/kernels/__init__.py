"""The CUDA kernels of the port, their plain versions and their dispatch."""

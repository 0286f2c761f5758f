"""Feature ops; the CUDA kernels and their wrappers live in ops/cuda."""

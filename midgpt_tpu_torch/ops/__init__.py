"""Hand-written CUDA kernels, their wrappers and plain versions."""

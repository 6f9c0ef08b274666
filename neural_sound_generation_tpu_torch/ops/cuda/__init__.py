"""Hand-written CUDA kernels of the port, each with its plain PyTorch version."""

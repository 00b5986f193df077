"""Hand-written CUDA kernels: wrappers, plain PyTorch versions, build."""

"""Hand-written CUDA kernels: wrappers, plain PyTorch versions and the build."""

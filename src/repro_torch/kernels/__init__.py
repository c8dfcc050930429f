"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version and a launch counter, plus the planned-op wrappers around them."""

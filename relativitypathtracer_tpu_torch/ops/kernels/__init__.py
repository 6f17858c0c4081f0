"""Hand-written CUDA kernels (csrc/) behind wrappers with plain PyTorch twins."""

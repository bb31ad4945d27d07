"""Hot kernels: a hand-written CUDA kernel per TPU kernel of the reference,
each beside its plain PyTorch version (the one CPU tensors take)."""

"""Device kernels: each a hand-written CUDA kernel (csrc/), its plain
PyTorch version and the wrapper that picks between them by the tensor's
device."""

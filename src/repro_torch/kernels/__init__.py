# Hand-written CUDA kernels (csrc/), their ctypes wrappers with plain
# PyTorch twins, the public ops and the matmul backend registry.

"""PyTorch and CUDA port of the ``repro`` package, for one NVIDIA H100.

Mirrors the JAX package's layout module for module and imports nothing of
it (nor JAX). Every Pallas TPU kernel on a ported path is a hand-written
CUDA kernel under ``kernels/csrc/``, built with ``nvcc`` at first use.
"""

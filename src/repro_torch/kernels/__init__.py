"""Hand-written Hopper kernels of the port.

Each kernel's CUDA source lives under ``repro_torch/csrc``; its package
here holds the wrapper (which launches the kernel for CUDA tensors and runs
the plain PyTorch version for CPU tensors) and a launch counter.
"""

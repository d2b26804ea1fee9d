"""The benchmark of the PyTorch/CUDA D4M port (``repro_torch``): see README.md."""

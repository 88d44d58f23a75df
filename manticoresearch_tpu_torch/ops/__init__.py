"""Device-side search operators and kernels (PyTorch / CUDA)."""

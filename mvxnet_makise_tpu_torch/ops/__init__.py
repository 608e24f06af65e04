"""Tensor operations and the port's CUDA kernels (column_merge: K1,
gather: K2)."""

"""Flat-vector substrate, the count sketch and its CUDA kernels."""

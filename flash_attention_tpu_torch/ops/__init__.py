"""Attention operators of the PyTorch port and their CUDA kernels."""

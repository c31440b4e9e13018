"""Kernels and operators of the PyTorch port."""

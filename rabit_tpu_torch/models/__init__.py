"""Workloads of the PyTorch port."""

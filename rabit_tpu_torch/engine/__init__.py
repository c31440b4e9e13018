"""Engines behind the host API of the PyTorch port."""

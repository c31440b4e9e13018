"""Process groups and collectives of the PyTorch port."""

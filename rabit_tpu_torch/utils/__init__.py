"""Framework-neutral helpers of the PyTorch port."""

"""serving of the PyTorch port."""

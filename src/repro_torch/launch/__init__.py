"""Launch entry points of the PyTorch port."""

"""Training substrate of the PyTorch port: AdamW, the train step, checkpoints."""

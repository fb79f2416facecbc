"""Sharding of the port over a ``torch.distributed`` device mesh."""

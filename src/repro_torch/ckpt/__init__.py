"""Checkpoints of train-state trees, in the reference's on-disk format."""

"""Inference half of the trainer: eval step, init and checkpoints."""

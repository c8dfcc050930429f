"""Asynchronous checkpoints with atomic commits."""

"""Checkpoints of tensor pytrees (``ckpt.checkpointer``)."""

"""The paper's distributed conv and matmul on explicit process grids, per
rank over ``torch.distributed``, with their backward passes, and the
grid-parallel CNN train step (``dist.train``)."""

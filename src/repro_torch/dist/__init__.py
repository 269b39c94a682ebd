"""The paper's distributed conv and matmul on explicit process grids,
per rank over ``torch.distributed`` (forward only in this slice)."""

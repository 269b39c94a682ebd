"""llama3.2-1b [dense] — 16L d=2048 32H (GQA kv=8) ff=8192 vocab=128256.
[hf:meta-llama/Llama-3.2-1B]"""

import dataclasses

from repro_torch.models.config import ModelConfig

_BASE = ModelConfig(
    arch_id="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab=128256, rope_theta=500000.0, mlp_act="swiglu",
)


def config() -> ModelConfig:
    return _BASE


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        _BASE, head_dim=None, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, remat=False)

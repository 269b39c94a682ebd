"""smollm-360m [dense] — 32L d=960 15H (GQA kv=5) ff=2560 vocab=49152.
[hf:HuggingFaceTB/SmolLM-360M]"""

import dataclasses

from repro_torch.models.config import ModelConfig

_BASE = ModelConfig(
    arch_id="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab=49152, rope_theta=10000.0, mlp_act="swiglu",
)


def config() -> ModelConfig:
    return _BASE


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        _BASE, head_dim=None, n_layers=2, d_model=60, n_heads=3, n_kv_heads=1,
        d_ff=96, vocab=256, remat=False)

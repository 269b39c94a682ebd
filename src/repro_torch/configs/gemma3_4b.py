"""gemma3-4b [dense] — 34L d=2560 8H (GQA kv=4) ff=10240 vocab=262144,
5:1 local:global sliding-window attention.  [hf:google/gemma-3-4b-pt]"""

import dataclasses

from repro_torch.models.config import ModelConfig

_BASE = ModelConfig(
    arch_id="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4,
    d_ff=10240, vocab=262144, rope_theta=1000000.0, mlp_act="geglu",
    attn_pattern_period=6, sliding_window=1024,
)


def config() -> ModelConfig:
    return _BASE


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        _BASE, head_dim=None, n_layers=6, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, sliding_window=8, remat=False)

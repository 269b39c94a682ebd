"""gemma3-12b [dense] — 48L d=3840 16H (GQA kv=8) ff=15360 vocab=262144,
5:1 local:global sliding-window attention.  [hf:google/gemma-3-12b-pt]"""

import dataclasses

from repro_torch.models.config import ModelConfig

_BASE = ModelConfig(
    arch_id="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8,
    d_ff=15360, vocab=262144, rope_theta=1000000.0, mlp_act="geglu",
    attn_pattern_period=6, sliding_window=1024, fsdp=True,
)


def config() -> ModelConfig:
    return _BASE


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        _BASE, head_dim=None, n_layers=6, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, sliding_window=8, remat=False, fsdp=False)

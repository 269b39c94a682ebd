"""granite-moe-1b-a400m [moe] — 24L d=1024 16H (GQA kv=8), MoE 32 experts
top-8, expert ff=512, vocab=49155.
[hf:ibm-granite/granite-3.0-1b-a400m-base]"""

import dataclasses

from repro_torch.models.config import ModelConfig

_BASE = ModelConfig(
    arch_id="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=512, vocab=49155, mlp_act="swiglu",
    n_experts=32, top_k=8,
)


def config() -> ModelConfig:
    return _BASE


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        _BASE, head_dim=None, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=32, vocab=256, n_experts=4, top_k=2, remat=False)

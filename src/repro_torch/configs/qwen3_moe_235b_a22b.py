"""qwen3-moe-235b-a22b [moe] — 94L d=4096 64H (GQA kv=4), MoE 128 experts
top-8, expert ff=1536, vocab=151936.  [hf:Qwen/Qwen3-235B-A22B]"""

import dataclasses

from repro_torch.models.config import ModelConfig

_BASE = ModelConfig(
    arch_id="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=1536, vocab=151936, mlp_act="swiglu",
    n_experts=128, top_k=8, fsdp=True,
)


def config() -> ModelConfig:
    return _BASE


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        _BASE, head_dim=None, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=32, vocab=256, n_experts=8, top_k=2, remat=False, fsdp=False)

"""qwen2-vl-72b [vlm] — 80L d=8192 64H (GQA kv=8) ff=29568 vocab=152064,
M-RoPE (t/h/w sections), dynamic-resolution vision frontend stubbed to
precomputed patch embeddings.  [arXiv:2409.12191]"""

import dataclasses

from repro_torch.models.config import ModelConfig

_BASE = ModelConfig(
    arch_id="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab=152064, rope_theta=1000000.0, mlp_act="swiglu",
    mrope_sections=(16, 24, 24), fsdp=True,
)


def config() -> ModelConfig:
    return _BASE


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        _BASE, head_dim=None, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, mrope_sections=(2, 3, 3), remat=False,
        fsdp=False)

"""zamba2-7b [hybrid] — 81L Mamba2 d=3584 + shared attention block
(32H MHA kv=32, ff=14336), ssm_state=64, vocab=32000.  [arXiv:2411.15242]"""

import dataclasses

from repro_torch.models.config import ModelConfig

_BASE = ModelConfig(
    arch_id="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000, mlp_act="swiglu",
    ssm_state=64, ssm_expand=2, ssm_chunk=256, attn_every=6,
)


def config() -> ModelConfig:
    return _BASE


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        _BASE, head_dim=None, n_layers=6, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256, ssm_state=16, ssm_chunk=16, attn_every=3,
        remat=False)

"""xlstm-350m [ssm] — 24L d=1024 4H, mLSTM blocks with periodic sLSTM,
vocab=50304, no separate FFN (d_ff=0).  [arXiv:2405.04517]"""

import dataclasses

from repro_torch.models.config import ModelConfig

_BASE = ModelConfig(
    arch_id="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304, ssm_expand=2, ssm_chunk=256, slstm_every=4,
)


def config() -> ModelConfig:
    return _BASE


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        _BASE, head_dim=None, n_layers=4, d_model=64, n_heads=2, n_kv_heads=2,
        vocab=256, ssm_chunk=16, slstm_every=4, remat=False)

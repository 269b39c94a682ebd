"""whisper-tiny [audio] — enc-dec backbone, 4L enc + 4L dec, d=384 6H
ff=1536 vocab=51865; conv frontend is a stub (precomputed frame
embeddings).  [arXiv:2212.04356]"""

import dataclasses

from repro_torch.models.config import ModelConfig

_BASE = ModelConfig(
    arch_id="whisper-tiny", family="encdec",
    n_layers=4, n_enc_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab=51865, mlp_act="gelu",
)


def config() -> ModelConfig:
    return _BASE


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        _BASE, head_dim=None, n_layers=2, n_enc_layers=2, d_model=48,
        n_heads=2, n_kv_heads=2, d_ff=96, vocab=256, remat=False)

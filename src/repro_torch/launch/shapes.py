"""The assigned input-shape grid and the stand-ins of every cell's
inputs -- the port of ``repro/launch/shapes.py``.

  train_4k      seq 4096,   global_batch 256   -> train_step
  prefill_32k   seq 32768,  global_batch 32    -> prefill (serve)
  decode_32k    cache 32768, global_batch 128  -> decode_step (serve)
  long_500k     cache 524288, global_batch 1   -> decode_step (serve)

long_500k runs only for sub-quadratic archs (SSM / hybrid / gemma3's 5:1
sliding-window pattern); pure full-attention archs skip it.

Where the reference returns ``jax.ShapeDtypeStruct``s, the stand-ins here
are tensors on the ``meta`` device: a shape and a dtype, no storage.
Nothing is allocated.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.models.config import ModelConfig

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# sub-quadratic families/archs allowed to run long_500k
_LONG_OK_FAMILIES = ("ssm", "hybrid")
_LONG_OK_ARCHS = ("gemma3-12b", "gemma3-4b")

# whisper encoder frame budget for decode cells (cross-attention length)
WHISPER_DECODE_ENC_LEN = 4096
VLM_PATCHES = 1024


def cell_supported(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k":
        if (cfg.family in _LONG_OK_FAMILIES
                or cfg.arch_id in _LONG_OK_ARCHS):
            return True, ""
        return False, ("pure full-attention arch: long_500k needs "
                       "sub-quadratic attention (DESIGN.md §5)")
    return True, ""


def sds(shape, dtype) -> torch.Tensor:
    """A ``meta`` tensor of ``shape`` and ``dtype``: the counterpart of a
    ``jax.ShapeDtypeStruct``."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape_name: str) -> Dict:
    """Stand-ins for every model input of this cell.

    For train: the batch dict.  For prefill: prompt tokens (+frames).
    For decode: single-token batch (the cache is built separately by
    :func:`cache_struct`)."""
    sp = SHAPES[shape_name]
    b, s = sp.global_batch, sp.seq_len
    if sp.kind == "train":
        batch = {"tokens": sds((b, s), I32), "labels": sds((b, s), I32)}
        if cfg.family == "encdec":
            batch["frames"] = sds((b, s, cfg.d_model), torch.float32)
        if cfg.family == "vlm":
            batch["positions"] = sds((b, 3, s), I32)
            batch["vision_embeds"] = sds((b, VLM_PATCHES, cfg.d_model),
                                         torch.float32)
        return batch
    if sp.kind == "prefill":
        out = {"tokens": sds((b, s), I32)}
        if cfg.family == "encdec":
            out["frames"] = sds((b, s, cfg.d_model), torch.float32)
            out["tokens"] = sds((b, min(s, 448)), I32)  # whisper ctx limit
        return out
    # decode: one new token against a cache of length seq_len
    return {"tokens": sds((b, 1), I32)}


def cache_struct(cfg: ModelConfig, shape_name: str) -> Dict:
    """The serve cache of this cell as ``meta`` tensors (the family's
    ``init_cache``; the encoder-decoder's cross K/V over
    :data:`WHISPER_DECODE_ENC_LEN` frames)."""
    from repro_torch.models.api import model_fns
    sp = SHAPES[shape_name]
    kw = {"device": "meta"}
    if cfg.family == "encdec":
        kw["enc_len"] = WHISPER_DECODE_ENC_LEN
    return model_fns(cfg).init_cache(cfg, sp.global_batch, sp.seq_len, **kw)

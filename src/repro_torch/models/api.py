"""Uniform model API: the family registry of init / forward / serve
functions -- the port of ``repro/models/api.py``.

Every architecture exposes::

  init(generator, cfg, *, device=None) -> params
  loss(params, cfg, batch) -> scalar                 (train objective)
  forward(params, cfg, tokens, ...) -> hidden        (None for encdec)
  init_cache(cfg, batch, max_seq, **kw) -> cache     (serve state)
  prefill(params, cfg, cache, ...) -> (logits, cache)
  decode_step(params, cfg, cache, tokens) -> (logits, cache)

``init_cache`` takes ``device=`` (``cuda`` by default), the transformer
families ``per_slot=`` and the encoder-decoder ``enc_len=`` (default
``max_seq``).  ``loss`` takes the batch of ``data.pipeline``
(``tokens``, ``labels``; the encoder's ``frames``, the vlm's
``positions``); the transformer families' also take ``dist_mesh=`` /
``dist_schedule=``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from repro_torch.models import encdec, hybrid, lm, ssm_lm
from repro_torch.models.config import ModelConfig

@dataclasses.dataclass(frozen=True)
class ModelFns:
    init: Callable
    loss: Callable
    forward: Callable
    init_cache: Callable
    prefill: Callable
    decode_step: Callable


_TRANSFORMER = ModelFns(
    init=lm.init_lm, loss=lm.loss_lm, forward=lm.forward_lm,
    init_cache=lambda cfg, batch, max_seq, **kw: lm.init_cache(
        cfg, batch, max_seq, per_slot=kw.get("per_slot", False),
        device=kw.get("device")),
    prefill=lm.prefill, decode_step=lm.decode_step)

_SSM = ModelFns(
    init=ssm_lm.init_ssm_lm, loss=ssm_lm.loss_ssm_lm,
    forward=ssm_lm.forward_ssm_lm,
    init_cache=lambda cfg, batch, max_seq, **kw: ssm_lm.init_cache_ssm(
        cfg, batch, max_seq, device=kw.get("device")),
    prefill=ssm_lm.prefill_ssm, decode_step=ssm_lm.decode_step_ssm)

_HYBRID = ModelFns(
    init=hybrid.init_hybrid, loss=hybrid.loss_hybrid,
    forward=hybrid.forward_hybrid,
    init_cache=lambda cfg, batch, max_seq, **kw: hybrid.init_cache_hybrid(
        cfg, batch, max_seq, device=kw.get("device")),
    prefill=hybrid.prefill_hybrid, decode_step=hybrid.decode_step_hybrid)

_ENCDEC = ModelFns(
    init=encdec.init_encdec, loss=encdec.loss_encdec,
    forward=None,
    init_cache=lambda cfg, batch, max_seq, **kw: encdec.init_cache_encdec(
        cfg, batch, max_seq, kw.get("enc_len", max_seq),
        device=kw.get("device")),
    prefill=encdec.prefill_encdec, decode_step=encdec.decode_step_encdec)

FAMILIES: Dict[str, ModelFns] = {
    "dense": _TRANSFORMER,
    "moe": _TRANSFORMER,
    "vlm": _TRANSFORMER,
    "ssm": _SSM,
    "hybrid": _HYBRID,
    "encdec": _ENCDEC,
}


def model_fns(cfg: ModelConfig) -> ModelFns:
    return FAMILIES[cfg.family]

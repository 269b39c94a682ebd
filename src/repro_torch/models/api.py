"""Uniform model API: the family registry of init / forward / serve
functions -- the port of ``repro/models/api.py``.

Every transformer architecture exposes::

  init(generator, cfg, *, device=None) -> params
  loss(params, cfg, batch) -> scalar                 (waits for LM training)
  forward(params, cfg, tokens, ...) -> hidden
  init_cache(cfg, batch, max_seq, **kw) -> cache     (serve state)
  prefill(params, cfg, cache, tokens, ...) -> (logits, cache)
  decode_step(params, cfg, cache, tokens) -> (logits, cache)

The ``ssm``, ``hybrid`` and ``encdec`` families (``models/ssm_lm.py``,
``hybrid.py``, ``encdec.py`` in the reference) wait for the zoo slice:
:func:`model_fns` raises ``NotImplementedError`` for them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig

ZOO_LATER = ("the {family!r} family waits for the zoo slice of the port "
             "(repro/models/ssm_lm.py, hybrid.py, encdec.py)")
LM_TRAINING_LATER = ("loss_lm waits for the LM-training slice of the port "
                     "(chunked_cross_entropy, the flash-attention backward)")


@dataclasses.dataclass(frozen=True)
class ModelFns:
    init: Callable
    loss: Callable
    forward: Callable
    init_cache: Callable
    prefill: Callable
    decode_step: Callable


def _loss_later(params, cfg, batch, **kw):
    raise NotImplementedError(LM_TRAINING_LATER)


_TRANSFORMER = ModelFns(
    init=lm.init_lm, loss=_loss_later, forward=lm.forward_lm,
    init_cache=lambda cfg, batch, max_seq, **kw: lm.init_cache(
        cfg, batch, max_seq, per_slot=kw.get("per_slot", False),
        device=kw.get("device")),
    prefill=lm.prefill, decode_step=lm.decode_step)

FAMILIES: Dict[str, ModelFns] = {
    "dense": _TRANSFORMER,
    "moe": _TRANSFORMER,
    "vlm": _TRANSFORMER,
}


def model_fns(cfg: ModelConfig) -> ModelFns:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(ZOO_LATER.format(family=cfg.family))
    return FAMILIES[cfg.family]

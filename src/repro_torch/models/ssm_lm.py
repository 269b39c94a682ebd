"""xLSTM-style LM (family "ssm"): mLSTM blocks with periodic sLSTM blocks
-- the port of ``repro/models/ssm_lm.py``.

The reference scans the stacked mLSTM layers, then the stacked sLSTM
layers (depth-interleaving is order-equivalent for these residual stacks
at its scale); the port keeps one parameter dict per layer
(``params["mblocks"]``, ``params["sblocks"]``) and runs the same order as
Python loops.  Decode carries per-layer recurrent states -- O(1) memory
in sequence length.  The cache keeps the reference's stacked layout;
``prefill_ssm`` and ``decode_step_ssm`` write each layer's new state into
it in place and return a dict sharing those tensors with the new
``len``.  ``cfg.remat`` checkpoints each layer of the training forward
(``layers.remat``), as the reference's ``jax.checkpoint`` of its scan
bodies.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models import ssm
from repro_torch.models.config import ModelConfig


def _n_slstm(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.slstm_every if cfg.slstm_every else 0


def init_ssm_lm(generator: torch.Generator, cfg: ModelConfig, *,
                device=None) -> Dict:
    """Random parameters drawn from ``generator``, scaled as the
    reference's ``init_ssm_lm``, on ``device`` (``cuda`` by default)."""
    device = resolve_device(device)
    dt = cfg.torch_dtype
    n_s = _n_slstm(cfg)
    params = {
        "emb": L.init_embeddings(generator, cfg.vocab, cfg.d_model, dt,
                                 device),
        "mblocks": [{
            "ln": L.init_rmsnorm(cfg.d_model, dt, device),
            "mlstm": ssm.init_mlstm(generator, cfg.d_model,
                                    expand=cfg.ssm_expand,
                                    n_heads=cfg.n_heads, dtype=dt,
                                    device=device),
        } for _ in range(cfg.n_layers - n_s)],
        "ln_f": L.init_rmsnorm(cfg.d_model, dt, device),
    }
    if n_s:
        params["sblocks"] = [{
            "ln": L.init_rmsnorm(cfg.d_model, dt, device),
            "slstm": ssm.init_slstm(generator, cfg.d_model,
                                    n_heads=cfg.n_heads, dtype=dt,
                                    device=device),
        } for _ in range(n_s)]
    return params


def _apply_stacks(params: Dict, cfg: ModelConfig, h: torch.Tensor, *,
                  states: Optional[Dict], decode: bool
                  ) -> torch.Tensor:
    """The mLSTM stack, then the sLSTM stack.  With ``states`` (the
    cache's ``{"m", "s"}``) each layer starts from its state there and
    writes its new one back; without, each layer is checkpointed under
    ``cfg.remat``."""
    track = decode or states is not None

    def mlayer(blk, hh, st=None):
        y, st2 = ssm.mlstm_block(blk["mlstm"],
                                 L.rmsnorm(hh, blk["ln"], cfg.norm_eps),
                                 expand=cfg.ssm_expand, n_heads=cfg.n_heads,
                                 chunk=cfg.ssm_chunk, ssm_state=st,
                                 decode=decode)
        return hh + y, st2

    def slayer(blk, hh, st=None):
        y, st2 = ssm.slstm_block(blk["slstm"],
                                 L.rmsnorm(hh, blk["ln"], cfg.norm_eps),
                                 n_heads=cfg.n_heads, ssm_state=st,
                                 decode=decode)
        return hh + y, st2

    if not track:
        mlayer = L.remat(mlayer, cfg.remat)
        slayer = L.remat(slayer, cfg.remat)
    for i, blk in enumerate(params["mblocks"]):
        st = {"ssd": states["m"]["ssd"][i]} if track else None
        h, st2 = mlayer(blk, h, st)
        if track:
            ssm.write_back(states["m"], i, st, st2)
    for i, blk in enumerate(params.get("sblocks", [])):
        st = ({key: states["s"][key][i] for key in ("c", "n", "h")}
              if track else None)
        h, st2 = slayer(blk, h, st)
        if track:
            ssm.write_back(states["s"], i, st, st2)
    return h


def forward_ssm_lm(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                   positions=None, vision_embeds=None) -> torch.Tensor:
    """tokens: [B,S] -> hidden [B,S,d] (pre-logits, final-normed)."""
    h = L.embed(params["emb"], tokens)
    h = _apply_stacks(params, cfg, h, states=None, decode=False)
    return L.rmsnorm(h, params["ln_f"], cfg.norm_eps)


def loss_ssm_lm(params: Dict, cfg: ModelConfig, batch: Dict
                ) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` (``tokens``,
    ``labels`` [B,S])."""
    h = forward_ssm_lm(params, cfg, batch["tokens"])
    return L.chunked_cross_entropy(h, params["emb"]["lm_head"],
                                   batch["labels"])


def init_cache_ssm(cfg: ModelConfig, batch: int, max_seq: int, *,
                   device=None) -> Dict:
    """Recurrent state 'cache' -- size independent of ``max_seq`` -- on
    ``device`` (``cuda`` by default), float32 as the reference's."""
    device = resolve_device(device)
    di = cfg.ssm_expand * cfg.d_model
    hd = di // cfg.n_heads
    n_s = _n_slstm(cfg)
    n_m = cfg.n_layers - n_s
    f32 = dict(dtype=torch.float32, device=device)
    cache = {
        "m": {"ssd": torch.zeros((n_m, batch, cfg.n_heads, hd, hd + 1),
                                 **f32)},
        "s": None,
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }
    if n_s:
        shape = (n_s, batch, cfg.n_heads, cfg.d_model // cfg.n_heads)
        # three tensors: they are written in place
        cache["s"] = {key: torch.zeros(shape, **f32)
                      for key in ("c", "n", "h")}
    return cache


def decode_step_ssm(params: Dict, cfg: ModelConfig, cache: Dict,
                    tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """tokens: [B,1] -> (logits [B,1,V] f32, cache with ``len + 1``)."""
    h = L.embed(params["emb"], tokens)
    h = _apply_stacks(params, cfg, h, states=cache, decode=True)
    return lm._head(params, cfg, h, None), dict(cache, len=cache["len"] + 1)


def prefill_ssm(params: Dict, cfg: ModelConfig, cache: Dict,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """tokens: [B,S] -> (the last position's logits [B,1,V] f32, cache
    with ``len + S``)."""
    h = L.embed(params["emb"], tokens)
    h = _apply_stacks(params, cfg, h, states=cache, decode=False)
    return (lm._head(params, cfg, h[:, -1:], None),
            dict(cache, len=cache["len"] + tokens.shape[1]))

"""Zamba2-style hybrid LM (family "hybrid"): a Mamba2 backbone with one
SHARED attention+MLP block applied every ``cfg.attn_every`` layers -- the
port of ``repro/models/hybrid.py``.

The reference scans the Mamba2 layers and applies the shared block under
``lax.cond`` at flagged depths; here the layers are a Python loop (one
parameter dict per layer in ``params["mblocks"]``) and the flag a Python
``if``, with a counter of the shared block's applications where the
reference takes a cumsum of the flags.  Decode keeps one KV cache row
per application ([n_apps, B, Smax, G, hd]) plus the per-layer Mamba2
conv/SSD states, in the reference's stacked layout; ``prefill_hybrid``
and ``decode_step_hybrid`` write them in place and return a dict sharing
those tensors with the new ``len``.  The shared block is the decoder
LM's attention + MLP block (``models/lm.py``), which computes the same
function.  ``cfg.remat`` checkpoints each layer of the training forward
(the Mamba2 block and, where flagged, the shared block after it), as the
reference's ``jax.checkpoint`` of its scan body.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models import ssm
from repro_torch.models.config import ModelConfig

MAMBA_STATES = ("conv_x", "conv_B", "conv_C", "ssd")


def _n_apps(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.attn_every if cfg.attn_every else 0


def init_hybrid(generator: torch.Generator, cfg: ModelConfig, *,
                device=None) -> Dict:
    """Random parameters drawn from ``generator``, scaled as the
    reference's ``init_hybrid``, on ``device`` (``cuda`` by default)."""
    device = resolve_device(device)
    dt = cfg.torch_dtype
    return {
        "emb": L.init_embeddings(generator, cfg.vocab, cfg.d_model, dt,
                                 device),
        "mblocks": [{
            "ln": L.init_rmsnorm(cfg.d_model, dt, device),
            "mamba": ssm.init_mamba2(generator, cfg.d_model,
                                     expand=cfg.ssm_expand,
                                     state=cfg.ssm_state,
                                     head_dim=cfg.head_dim, dtype=dt,
                                     device=device),
        } for _ in range(cfg.n_layers)],
        "shared": {
            "ln1": L.init_rmsnorm(cfg.d_model, dt, device),
            "ln2": L.init_rmsnorm(cfg.d_model, dt, device),
            "attn": L.init_attention(generator, cfg.d_model, cfg.n_heads,
                                     cfg.n_kv_heads, cfg.head_dim, dt,
                                     device),
            "mlp": L.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.mlp_act,
                              dt, device),
        },
        "ln_f": L.init_rmsnorm(cfg.d_model, dt, device),
    }


def _attn_flags(cfg: ModelConfig) -> List[bool]:
    """Per layer: whether the shared block follows it."""
    if cfg.attn_every:
        return [i % cfg.attn_every == cfg.attn_every - 1
                for i in range(cfg.n_layers)]
    return [False] * cfg.n_layers


def _mamba(blk: Dict, h: torch.Tensor, cfg: ModelConfig, **kw):
    return ssm.mamba2_block(blk["mamba"], L.rmsnorm(h, blk["ln"],
                                                    cfg.norm_eps),
                            expand=cfg.ssm_expand, state=cfg.ssm_state,
                            head_dim=cfg.head_dim, chunk=cfg.ssm_chunk, **kw)


def forward_hybrid(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                   positions=None, vision_embeds=None) -> torch.Tensor:
    """tokens: [B,S] -> hidden [B,S,d] (pre-logits, final-normed)."""
    b, s = tokens.shape
    h = L.embed(params["emb"], tokens)
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device).expand(b, s)

    def layer(blk, shared, hh, flag):
        y, _ = _mamba(blk, hh, cfg)
        hh = hh + y
        if flag:
            hh, _ = lm._block_apply(shared, hh, cfg=cfg,
                                    positions=positions, window=0)
        return hh

    layer = L.remat(layer, cfg.remat)
    for blk, flag in zip(params["mblocks"], _attn_flags(cfg)):
        h = layer(blk, params["shared"], h, flag)
    return L.rmsnorm(h, params["ln_f"], cfg.norm_eps)


def loss_hybrid(params: Dict, cfg: ModelConfig, batch: Dict
                ) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` (``tokens``,
    ``labels`` [B,S])."""
    h = forward_hybrid(params, cfg, batch["tokens"])
    return L.chunked_cross_entropy(h, params["emb"]["lm_head"],
                                   batch["labels"])


# ---------------------------------------------------------------- serve ---

def init_cache_hybrid(cfg: ModelConfig, batch: int, max_seq: int, *,
                      device=None) -> Dict:
    """Mamba2 conv contexts (cfg dtype) and SSD states (f32) per layer,
    and K/V rows per shared-block application, on ``device`` (``cuda`` by
    default)."""
    device = resolve_device(device)
    di = cfg.ssm_expand * cfg.d_model
    nh = di // cfg.head_dim
    kv = (_n_apps(cfg), batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    dt = dict(dtype=cfg.torch_dtype, device=device)
    return {
        "conv_x": torch.zeros((cfg.n_layers, batch, 3, di), **dt),
        "conv_B": torch.zeros((cfg.n_layers, batch, 3, cfg.ssm_state), **dt),
        "conv_C": torch.zeros((cfg.n_layers, batch, 3, cfg.ssm_state), **dt),
        "ssd": torch.zeros((cfg.n_layers, batch, nh, cfg.ssm_state,
                            cfg.head_dim), dtype=torch.float32,
                           device=device),
        "k": torch.zeros(kv, **dt),
        "v": torch.zeros(kv, **dt),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


def _shared_block_cached(shared: Dict, h: torch.Tensor, ck, cv, *,
                         cfg: ModelConfig, pos: torch.Tensor
                         ) -> torch.Tensor:
    """The shared block on one token [B,1,d] against its application's
    K/V rows ``ck`` / ``cv`` [B,Smax,G,hd], this step's row written in
    place at ``pos``."""
    return lm._decode_block(shared, h, ck, cv, cfg=cfg, pos=pos, window=0)


def decode_step_hybrid(params: Dict, cfg: ModelConfig, cache: Dict,
                       tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """tokens: [B,1] -> (logits [B,1,V] f32, cache with ``len + 1``)."""
    h = L.embed(params["emb"], tokens)
    pos = cache["len"]
    app = 0
    for i, (blk, flag) in enumerate(zip(params["mblocks"],
                                        _attn_flags(cfg))):
        st = {key: cache[key][i] for key in MAMBA_STATES}
        y, st2 = _mamba(blk, h, cfg, ssm_state=st, decode=True)
        ssm.write_back(cache, i, st, st2)
        h = L.tp_replicate(h + y)
        if flag:
            h = _shared_block_cached(params["shared"], h, cache["k"][app],
                                     cache["v"][app], cfg=cfg, pos=pos)
            app += 1
    return lm._head(params, cfg, h, None), dict(cache, len=pos + 1)


def prefill_hybrid(params: Dict, cfg: ModelConfig, cache: Dict,
                   tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """The full forward with the states written: each layer's Mamba2
    states, and each application's roped K and V in bulk.  Returns the
    last position's logits [B,1,V] f32 and the cache with ``len = S``."""
    b, s = tokens.shape
    h = L.embed(params["emb"], tokens)
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    shared = params["shared"]
    app = 0
    for i, (blk, flag) in enumerate(zip(params["mblocks"],
                                        _attn_flags(cfg))):
        st = {key: cache[key][i] for key in MAMBA_STATES}
        y, st2 = _mamba(blk, h, cfg, ssm_state=st)
        ssm.write_back(cache, i, st, st2)
        h = L.tp_residual(h + y)
        if flag:
            h = L.tp_residual(lm._prefill_block(
                shared, h, cache["k"][app], cache["v"][app], cfg=cfg,
                positions=positions, window=0))
            app += 1
    length = torch.tensor(s, dtype=torch.int32, device=tokens.device)
    return lm._head(params, cfg, h[:, -1:], None), dict(cache, len=length)

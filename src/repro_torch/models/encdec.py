"""Whisper-style encoder-decoder backbone (family "encdec") -- the port of
``repro/models/encdec.py``.

As in the reference the audio frontend (log-mel + conv downsampling) is a
STUB: the caller gives precomputed frame embeddings [B, T, d].  The
backbone is the real thing: bidirectional encoder, causal decoder with
cross-attention, KV-cache decode (self + cross caches).  The reference
scans stacked layers; here each layer is a dict in ``params["enc"]`` /
``params["dec"]`` and the stacks are Python loops.  The cache keeps the
reference's stacked layout; ``prefill_encdec`` and
``decode_step_encdec`` write it in place and return a dict sharing those
tensors with the new ``len``.  ``cfg.remat`` checkpoints each encoder and
decoder layer of the training forward (``layers.remat``), as the
reference's ``jax.checkpoint`` of its scan bodies.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig


def init_encdec(generator: torch.Generator, cfg: ModelConfig, *,
                device=None) -> Dict:
    """Random parameters drawn from ``generator``, scaled as the
    reference's ``init_encdec``, on ``device`` (``cuda`` by default)."""
    device = resolve_device(device)
    dt = cfg.torch_dtype

    def norm():
        return L.init_rmsnorm(cfg.d_model, dt, device)

    def attn():
        return L.init_attention(generator, cfg.d_model, cfg.n_heads,
                                cfg.n_kv_heads, cfg.head_dim, dt, device)

    def mlp():
        return L.init_mlp(generator, cfg.d_model, cfg.d_ff, "gelu", dt,
                          device)

    return {
        "emb": L.init_embeddings(generator, cfg.vocab, cfg.d_model, dt,
                                 device),
        "enc": [{"ln1": norm(), "ln2": norm(), "attn": attn(), "mlp": mlp()}
                for _ in range(cfg.n_enc_layers)],
        "dec": [{"ln1": norm(), "ln2": norm(), "ln3": norm(),
                 "attn": attn(), "xattn": attn(), "mlp": mlp()}
                for _ in range(cfg.n_layers)],
        "ln_enc": norm(),
        "ln_f": norm(),
    }


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def encode(params: Dict, cfg: ModelConfig, frames: torch.Tensor
           ) -> torch.Tensor:
    """frames: [B, T, d] precomputed frame embeddings (stub frontend)."""
    b, t, _ = frames.shape
    positions = _positions(b, t, frames.device)

    def layer(blk, h):
        h = L.tp_residual(h + L.attention(
            blk["attn"], L.rmsnorm(h, blk["ln1"], cfg.norm_eps),
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, positions=positions,
            theta=cfg.rope_theta, causal=False))
        return h + L.mlp(blk["mlp"], L.rmsnorm(h, blk["ln2"], cfg.norm_eps),
                         "gelu")

    layer = L.remat(layer, cfg.remat)
    # under a pinned mesh the frames, then each sub-block's output,
    # sequence split over model (``layers.tp_residual``), as the decoder
    # LM's residual: DTensor otherwise lays out the first MLP's input so
    # that each model rank multiplies the whole ``w_up``
    h = L.tp_residual(frames.to(cfg.torch_dtype))
    for blk in params["enc"]:
        h = L.tp_residual(layer(blk, h))
    return L.rmsnorm(h, params["ln_enc"], cfg.norm_eps)


def _xkv(blk: Dict, enc_out: torch.Tensor, cfg: ModelConfig):
    mm = L._dense_mm
    k = L.split_heads(mm(enc_out, blk["xattn"]["wk"]), cfg.n_kv_heads,
                      cfg.head_dim)
    v = L.split_heads(mm(enc_out, blk["xattn"]["wv"]), cfg.n_kv_heads,
                      cfg.head_dim)
    return k, v


def _cross(blk: Dict, h: torch.Tensor, xk, xv, cfg: ModelConfig
           ) -> torch.Tensor:
    """Cross-attention of the decoder tokens on the encoder's K/V (the
    queries roped at position 0, the identity, as the reference)."""
    b, s, _ = h.shape
    return L.attention(blk["xattn"], L.rmsnorm(h, blk["ln2"], cfg.norm_eps),
                       n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                       head_dim=cfg.head_dim,
                       positions=torch.zeros((b, s), dtype=torch.int32,
                                             device=h.device),
                       theta=cfg.rope_theta, causal=False,
                       kv_override=(xk, xv))


def _mlp(blk: Dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return L.mlp(blk["mlp"], L.rmsnorm(h, blk["ln3"], cfg.norm_eps), "gelu")


def decode_train(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                 enc_out: torch.Tensor) -> torch.Tensor:
    """The decoder's forward: tokens [B,S] -> hidden [B,S,d]
    (final-normed)."""
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)

    def layer(blk, h):
        h = L.tp_residual(h + L.attention(
            blk["attn"], L.rmsnorm(h, blk["ln1"], cfg.norm_eps),
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, positions=positions,
            theta=cfg.rope_theta, causal=True))
        h = L.tp_residual(h + _cross(blk, h, *_xkv(blk, enc_out, cfg),
                                        cfg))
        return h + _mlp(blk, h, cfg)

    layer = L.remat(layer, cfg.remat)
    # the residual pinned as the encoder's (:func:`encode`)
    h = L.tp_residual(L.embed(params["emb"], tokens))
    for blk in params["dec"]:
        h = L.tp_residual(layer(blk, h))
    return L.rmsnorm(h, params["ln_f"], cfg.norm_eps)


def loss_encdec(params: Dict, cfg: ModelConfig, batch: Dict
                ) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` (``frames`` [B,T,d],
    ``tokens``, ``labels`` [B,S]) through the encoder and the decoder."""
    enc_out = encode(params, cfg, batch["frames"])
    h = decode_train(params, cfg, batch["tokens"], enc_out)
    return L.chunked_cross_entropy(h, params["emb"]["lm_head"],
                                   batch["labels"])


# ---------------------------------------------------------------- serve ---

def init_cache_encdec(cfg: ModelConfig, batch: int, max_seq: int,
                      enc_len: int, *, device=None) -> Dict:
    """Self-attention K/V rows [L,B,max_seq,G,hd] and the cross K/V of
    ``enc_len`` encoder frames, on ``device`` (``cuda`` by default)."""
    device = resolve_device(device)
    kv = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    xkv = (cfg.n_layers, batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
    dt = dict(dtype=cfg.torch_dtype, device=device)
    return {
        "k": torch.zeros(kv, **dt), "v": torch.zeros(kv, **dt),
        "xk": torch.zeros(xkv, **dt), "xv": torch.zeros(xkv, **dt),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


def prefill_encdec(params: Dict, cfg: ModelConfig, cache: Dict,
                   frames: torch.Tensor, tokens: torch.Tensor
                   ) -> Tuple[torch.Tensor, Dict]:
    """Encode, write the cross K/V, run the decoder prompt and fill its
    self K/V.  Returns the last position's logits [B,1,V] f32 and the
    cache with ``len = S``."""
    enc_out = encode(params, cfg, frames)
    b, s = tokens.shape
    h = L.tp_residual(L.embed(params["emb"], tokens))
    positions = _positions(b, s, tokens.device)
    # the cross K/V go into the cache in place when it holds this many
    # frames; else, as the reference returns them, as new leaves
    in_place = cache["xk"].shape[2] == enc_out.shape[1]
    xks, xvs = [], []
    for i, blk in enumerate(params["dec"]):
        h = L.tp_residual(h + lm._prefill_attention(
            blk, h, cache["k"][i], cache["v"][i], cfg=cfg,
            positions=positions, window=0))
        xk, xv = _xkv(blk, enc_out, cfg)
        if in_place:
            cache["xk"][i] = xk
            cache["xv"][i] = xv
        else:
            xks.append(xk.to(cfg.torch_dtype))
            xvs.append(xv.to(cfg.torch_dtype))
        h = L.tp_residual(h + _cross(blk, h, xk, xv, cfg))
        h = L.tp_residual(h + _mlp(blk, h, cfg))
    length = torch.tensor(s, dtype=torch.int32, device=tokens.device)
    out = dict(cache, len=length)
    if not in_place:
        out.update(xk=torch.stack(xks), xv=torch.stack(xvs))
    return lm._head(params, cfg, h[:, -1:], None), out


def decode_step_encdec(params: Dict, cfg: ModelConfig, cache: Dict,
                       tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """tokens: [B,1] -> (logits [B,1,V] f32, cache with ``len + 1``)."""
    b = tokens.shape[0]
    h = L.embed(params["emb"], tokens)
    pos = cache["len"]
    hd, nh, g = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    # under a pinned mesh each residual sum is pinned batch over data and
    # whole over model (``layers.replicate_model``), so each projection
    # runs on its weight's shard and none is gathered
    pin, mm = L.replicate_model, L._dense_mm
    for i, blk in enumerate(params["dec"]):
        h = pin(h + lm._cached_attention(blk, h, cache["k"][i],
                                         cache["v"][i], cfg=cfg, pos=pos,
                                         window=0))
        # cross attention against the cached encoder K/V
        xq = L.split_heads(mm(L.rmsnorm(h, blk["ln2"], cfg.norm_eps),
                              blk["xattn"]["wq"]), nh, hd)
        # as the self attention's (``lm._cached_attention``): the
        # scores split along the keys
        xo = L.cache_attention(xq, cache["xk"][i], cache["xv"][i],
                               mask=None, scale=hd ** -0.5)
        h = pin(h + mm(xo.reshape(b, 1, nh * hd), blk["xattn"]["wo"]))
        h = pin(h + _mlp(blk, h, cfg))
    return lm._head(params, cfg, h, None), dict(cache, len=pos + 1)

"""Decoder-only LM covering the dense / moe / vlm families -- the port of
``repro/models/lm.py``, its serving half.

Per-layer global/local attention flags (gemma3's 5:1 pattern), GQA +
RoPE / M-RoPE, dense-MLP or MoE feed-forward.  The reference scans over
stacked layer parameters on its dense path and unrolls its dist path;
the port keeps one parameter dict per layer (``params["blocks"]`` is a
list) and unrolls both as a Python loop.

Serving: :func:`init_cache` + :func:`prefill` + :func:`decode_step` on a
static-shape KV cache.  The reference is functional and returns new
cache arrays; here ``prefill`` and ``decode_step`` write the new K/V rows
into ``cache["k"]`` / ``cache["v"]`` in place and return a dict that
shares those tensors with the new ``len``.

``dist_mesh`` routes every projection through
``dist.lm.dist_projection`` (``dist.matmul.matmul_distributed`` on the
``(Pm, Pn, Pc)`` grid) and the MoE expert FFN through
``dist.lm.expert_ffn_distributed``.  ``loss_lm`` waits for LM training.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import ModelConfig

# ------------------------------------------------------------------ init --


def init_block(generator, cfg: ModelConfig, device=None) -> Dict:
    dt = cfg.torch_dtype
    blk = {
        "ln1": L.init_rmsnorm(cfg.d_model, dt, device),
        "ln2": L.init_rmsnorm(cfg.d_model, dt, device),
        "attn": L.init_attention(generator, cfg.d_model, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.head_dim, dt, device),
    }
    if cfg.is_moe:
        blk["moe"] = moe_mod.init_moe(generator, cfg.d_model, cfg.d_ff,
                                      cfg.n_experts, dt, device)
    else:
        blk["mlp"] = L.init_mlp(generator, cfg.d_model, cfg.d_ff,
                                cfg.mlp_act, dt, device)
    return blk


def init_lm(generator: torch.Generator, cfg: ModelConfig, *,
            device=None) -> Dict:
    """Random parameters drawn from ``generator`` on its own device (a CPU
    generator gives the same weights on every device; a CUDA one draws a
    full-width model fast), scaled as the reference's ``init_lm``, on
    ``device`` (``cuda`` by default)."""
    device = resolve_device(device)
    return {
        "emb": L.init_embeddings(generator, cfg.vocab, cfg.d_model,
                                 cfg.torch_dtype, device),
        "blocks": [init_block(generator, cfg, device)
                   for _ in range(cfg.n_layers)],
        "ln_f": L.init_rmsnorm(cfg.d_model, cfg.torch_dtype, device),
    }


def layer_windows(cfg: ModelConfig) -> List[int]:
    """Per-layer sliding window (0 = global attention)."""
    p = cfg.attn_pattern_period
    if p > 0:
        return [0 if i % p == p - 1 else cfg.sliding_window
                for i in range(cfg.n_layers)]
    return [0] * cfg.n_layers


# --------------------------------------------------------------- forward --

def _make_mm(dist_mesh, dist_schedule: str):
    """Projection routing: ``x @ w`` -> ``dist.lm.dist_projection`` on
    the ``(Pm, Pn, Pc)`` serving mesh.  None without a mesh, so callers
    fall back to the dense matmul."""
    if dist_mesh is None:
        return None
    from repro_torch.dist import lm as dist_lm

    def mm(x, w, name=""):
        return dist_lm.dist_projection(x, w, dist_mesh,
                                       schedule=dist_schedule, name=name)
    return mm


def _mrope(cfg: ModelConfig):
    return cfg.mrope_sections if cfg.mrope_sections[0] else None


def _ffn(blk: Dict, h: torch.Tensor, *, cfg: ModelConfig, mm, dist_mesh,
         dist_schedule: str) -> tuple:
    """The block's second half on ``rmsnorm(h)``: (out, the MoE aux loss,
    0.0 for a dense MLP)."""
    x = L.rmsnorm(h, blk["ln2"], cfg.norm_eps)
    if cfg.is_moe:
        return moe_mod.moe_layer(blk["moe"], x, top_k=cfg.top_k,
                                 capacity_factor=cfg.capacity_factor,
                                 group_size=cfg.moe_group_size,
                                 dist_mesh=dist_mesh,
                                 dist_schedule=dist_schedule)
    return L.mlp(blk["mlp"], x, cfg.mlp_act, mm=mm), 0.0


def _block_apply(blk: Dict, h: torch.Tensor, *, cfg: ModelConfig,
                 positions: torch.Tensor, window: int, mm=None,
                 dist_mesh=None, dist_schedule: str = "allgather",
                 ) -> tuple:
    a = L.attention(blk["attn"], L.rmsnorm(h, blk["ln1"], cfg.norm_eps),
                    n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                    head_dim=cfg.head_dim, positions=positions,
                    theta=cfg.rope_theta, causal=True, window=window,
                    mrope_sections=_mrope(cfg), mm=mm)
    h = h + a
    m, aux = _ffn(blk, h, cfg=cfg, mm=mm, dist_mesh=dist_mesh,
                  dist_schedule=dist_schedule)
    return h + m, aux


def forward_lm(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
               positions: Optional[torch.Tensor] = None,
               vision_embeds: Optional[torch.Tensor] = None,
               dist_mesh=None,
               dist_schedule: str = "allgather") -> torch.Tensor:
    """tokens: [B,S] -> hidden [B,S,d] (pre-logits, final-normed).
    ``positions`` is [B,S], or [B,3,S] for M-RoPE; ``vision_embeds``
    (the VLM's stub frontend) replaces the first embeddings."""
    b, s = tokens.shape
    h = L.embed(params["emb"], tokens)
    if vision_embeds is not None:
        sv = vision_embeds.shape[1]
        h = torch.cat([vision_embeds.to(h.dtype), h[:, sv:]], dim=1)
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device).expand(b, s)
    mm = _make_mm(dist_mesh, dist_schedule)
    for blk, win in zip(params["blocks"], layer_windows(cfg)):
        h, _ = _block_apply(blk, h, cfg=cfg, positions=positions,
                            window=win, mm=mm, dist_mesh=dist_mesh,
                            dist_schedule=dist_schedule)
    return L.rmsnorm(h, params["ln_f"], cfg.norm_eps)


# ---------------------------------------------------------------- serve ---

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               per_slot: bool = False, device=None) -> Dict:
    """KV cache ``[n_layers, batch, max_seq, n_kv_heads, head_dim]`` on
    ``device`` (``cuda`` by default).  ``per_slot=True`` makes ``len`` a
    per-sequence [batch] vector (continuous batching: each slot advances
    independently); otherwise it is a scalar."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
        "len": torch.zeros((batch,) if per_slot else (), dtype=torch.int32,
                           device=device),
    }


def _cached_attention(blk: Dict, h: torch.Tensor, cache_k: torch.Tensor,
                      cache_v: torch.Tensor, *, cfg: ModelConfig,
                      pos: torch.Tensor, window: int, mm=None
                      ) -> torch.Tensor:
    """Single-token attention against the cache.  h: [B,1,d]; cache_k/v:
    [B,Smax,G,hd] (one layer's view, written in place); pos: a scalar
    current length, or a [B] vector of per-slot lengths."""
    b = h.shape[0]
    mm = mm if mm is not None else L._dense_mm
    hd, nh, g = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    per_slot = pos.dim() == 1
    x = L.rmsnorm(h, blk["ln1"], cfg.norm_eps)
    q = mm(x, blk["attn"]["wq"], "wq").reshape(b, 1, nh, hd)
    k = mm(x, blk["attn"]["wk"], "wk").reshape(b, 1, g, hd)
    v = mm(x, blk["attn"]["wv"], "wv").reshape(b, 1, g, hd)
    posb = (pos[:, None] if per_slot else pos.expand(b)[:, None])
    mrope = _mrope(cfg)
    if mrope is not None:
        pos3 = posb[:, None, :].expand(b, 3, 1)
        q = L.apply_mrope(q, pos3, cfg.rope_theta, mrope)
        k = L.apply_mrope(k, pos3, cfg.rope_theta, mrope)
    else:
        q = L.apply_rope(q, posb, cfg.rope_theta)
        k = L.apply_rope(k, posb, cfg.rope_theta)
    smax = cache_k.shape[1]
    kpos = torch.arange(smax, device=h.device)
    if per_slot:
        rows = torch.arange(b, device=h.device)
        cache_k[rows, pos.long()] = k[:, 0]
        cache_v[rows, pos.long()] = v[:, 0]
        valid = kpos[None, :] <= pos[:, None]
        if window > 0:
            valid &= kpos[None, :] > pos[:, None] - window
        mask = valid[:, None, None, :]
    else:
        p = int(pos)
        cache_k[:, p:p + 1] = k
        cache_v[:, p:p + 1] = v
        valid = kpos <= p
        if window > 0:
            valid &= kpos > p - window
        mask = valid[None, None, None, :]
    kk = L._repeat_kv(cache_k, nh // g)
    vv = L._repeat_kv(cache_v, nh // g)
    out = L.attention_scores(q, kk, vv, mask=mask, scale=hd ** -0.5)
    return mm(out.reshape(b, 1, nh * hd), blk["attn"]["wo"], "wo")


def _decode_block(blk: Dict, hh: torch.Tensor, ck, cv, *, cfg: ModelConfig,
                  pos: torch.Tensor, window: int, mm=None, dist_mesh=None,
                  dist_schedule: str = "allgather") -> torch.Tensor:
    hh = hh + _cached_attention(blk, hh, ck, cv, cfg=cfg, pos=pos,
                                window=window, mm=mm)
    m, _ = _ffn(blk, hh, cfg=cfg, mm=mm, dist_mesh=dist_mesh,
                dist_schedule=dist_schedule)
    return hh + m


def _head(params: Dict, cfg: ModelConfig, h: torch.Tensor, mm
          ) -> torch.Tensor:
    h = L.rmsnorm(h, params["ln_f"], cfg.norm_eps)
    mm = mm if mm is not None else L._dense_mm
    return mm(h, params["emb"]["lm_head"], "lm_head").float()


def decode_step(params: Dict, cfg: ModelConfig, cache: Dict,
                tokens: torch.Tensor, *, dist_mesh=None,
                dist_schedule: str = "allgather"
                ) -> Tuple[torch.Tensor, Dict]:
    """tokens: [B,1] -> (logits [B,1,V] f32, cache with ``len + 1``).

    ``cache["len"]`` may be a scalar or a per-slot [B] vector; this
    step's K/V rows are written into the cache in place."""
    h = L.embed(params["emb"], tokens)
    pos = cache["len"]
    mm = _make_mm(dist_mesh, dist_schedule)
    for i, (blk, win) in enumerate(zip(params["blocks"],
                                       layer_windows(cfg))):
        h = _decode_block(blk, h, cache["k"][i], cache["v"][i], cfg=cfg,
                          pos=pos, window=win, mm=mm, dist_mesh=dist_mesh,
                          dist_schedule=dist_schedule)
    return _head(params, cfg, h, mm), dict(cache, len=pos + 1)


def _prefill_block(blk: Dict, hh: torch.Tensor, ck, cv, *,
                   cfg: ModelConfig, positions: torch.Tensor, window: int,
                   mm=None, dist_mesh=None,
                   dist_schedule: str = "allgather") -> torch.Tensor:
    b, s = hh.shape[0], hh.shape[1]
    mm = mm if mm is not None else L._dense_mm
    x = L.rmsnorm(hh, blk["ln1"], cfg.norm_eps)
    q = mm(x, blk["attn"]["wq"], "wq").reshape(b, s, cfg.n_heads,
                                               cfg.head_dim)
    k = mm(x, blk["attn"]["wk"], "wk").reshape(b, s, cfg.n_kv_heads,
                                               cfg.head_dim)
    v = mm(x, blk["attn"]["wv"], "wv").reshape(b, s, cfg.n_kv_heads,
                                               cfg.head_dim)
    mrope = _mrope(cfg)
    if mrope is not None:
        pos3 = positions[:, None, :].expand(b, 3, s)
        q = L.apply_mrope(q, pos3, cfg.rope_theta, mrope)
        k = L.apply_mrope(k, pos3, cfg.rope_theta, mrope)
    else:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    ck[:, :s] = k
    cv[:, :s] = v
    o = L.attention_core(q, k, v, causal=True, window=window,
                         scale=cfg.head_dim ** -0.5)
    hh = hh + mm(o.reshape(b, s, -1), blk["attn"]["wo"], "wo")
    m, _ = _ffn(blk, hh, cfg=cfg, mm=mm, dist_mesh=dist_mesh,
                dist_schedule=dist_schedule)
    return hh + m


def prefill(params: Dict, cfg: ModelConfig, cache: Dict,
            tokens: torch.Tensor, *, last_pos=None, dist_mesh=None,
            dist_schedule: str = "allgather") -> Tuple[torch.Tensor, Dict]:
    """Fill the cache with a full prompt; returns the last position's
    logits [B,1,V] (f32) and the cache with its scalar ``len``.

    ``last_pos`` (an index) reads the logits at that position instead of
    ``-1`` -- used when the prompt is right-padded to a prefill bucket
    (causal attention keeps positions < the true length exact under right
    padding)."""
    b, s = tokens.shape
    h = L.embed(params["emb"], tokens)
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    mm = _make_mm(dist_mesh, dist_schedule)
    for i, (blk, win) in enumerate(zip(params["blocks"],
                                       layer_windows(cfg))):
        h = _prefill_block(blk, h, cache["k"][i], cache["v"][i], cfg=cfg,
                           positions=positions, window=win, mm=mm,
                           dist_mesh=dist_mesh, dist_schedule=dist_schedule)
    last = s - 1 if last_pos is None else int(last_pos)
    logits = _head(params, cfg, h[:, last:last + 1], mm)
    length = torch.tensor(last + 1, dtype=torch.int32, device=tokens.device)
    return logits, dict(cache, len=length)

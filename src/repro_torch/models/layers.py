"""Shared neural layers: norms, RoPE/M-RoPE, GQA attention, MLPs -- the
port of ``repro/models/layers.py``, its serving half.

Functional style: every layer is ``(params, inputs) -> outputs`` on
tensors, with an ``init_*`` companion that draws from an explicit
``torch.Generator``.  Attention masking supports causal, sliding-window
(gemma3 local layers) and bidirectional attention.  Computations
accumulate in f32 where it matters (norms, softmax, logits).  Attention is
plain torch code, written in the reference's summation order: the
reference has no Pallas kernel for it.

The projection hook ``mm`` takes ``(x, w, name)``: ``name`` is the
parameter's key (``"wq"``, ``"w_up"``, ...), which ``dist.lm`` uses to tag
each routed projection's collectives; the reference's hook takes
``(x, w)``.

Not here, by design: the flash-attention backward (``_flash_bwd``, the
``custom_vjp`` rules) and ``chunked_cross_entropy`` wait for LM
training; :func:`flash_attention` is its forward.  The reference's GSPMD
sharding pins (``set_attention_mesh``, ``_shard_heads``,
``replicate_model``, ``shard_residual``) annotate tensors for its
``gspmd`` mode; the port has no such mode (every routed projection is an
explicit per-rank op), so they are left out -- they would be the
identity -- and come with ``parallel/sharding.py`` in the zoo slice.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F


def _init(generator: torch.Generator, shape, scale=None,
          dtype=torch.float32, device=None) -> torch.Tensor:
    """Normal draws from ``generator`` (on its own device) times
    ``scale`` (default ``shape[0] ** -0.5``, as the reference), as
    ``dtype`` on ``device``."""
    scale = scale if scale is not None else shape[0] ** -0.5
    t = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (t * scale).to(device=device, dtype=dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


# ----------------------------------------------------------------- norms --

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * (1.0 + w.float())).to(x.dtype)


def init_rmsnorm(d: int, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.zeros((d,), dtype=dtype, device=device)


# ------------------------------------------------------------------ RoPE --

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate the two halves of ``x`` [B,S,H,D] by ``angles`` [B,S,D/2]."""
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] int."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)       # [D/2]
    return _rotate(x, positions[..., None].float() * freqs)      # [B,S,D/2]


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.  positions: [B, 3, S] (t, h, w streams);
    ``sections`` splits the D/2 frequency slots among the streams."""
    d2 = x.shape[-1] // 2
    if sum(sections) != d2:
        raise ValueError(f"M-RoPE sections {sections} must sum to {d2}")
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)       # [D/2]
    # angle slot i uses the position stream its section names
    stream = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.tensor(sections, device=x.device))                 # [D/2]
    pos = positions.float()[:, stream, :]                        # [B,D/2,S]
    return _rotate(x, pos.transpose(1, 2) * freqs)


# ------------------------------------------------------------- attention --

def init_attention(generator, d_model: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, dtype=torch.float32, device=None) -> Dict:
    kw = dict(dtype=dtype, device=device)
    return {
        "wq": _init(generator, (d_model, n_heads * head_dim), **kw),
        "wk": _init(generator, (d_model, n_kv_heads * head_dim), **kw),
        "wv": _init(generator, (d_model, n_kv_heads * head_dim), **kw),
        "wo": _init(generator, (n_heads * head_dim, d_model), **kw),
    }


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return x
    b, s, g, d = x.shape
    return x[:, :, :, None, :].expand(b, s, g, n_rep, d).reshape(
        b, s, g * n_rep, d)


def attention_scores(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     mask: Optional[torch.Tensor], scale: float
                     ) -> torch.Tensor:
    """q:[B,Sq,H,D] k,v:[B,Sk,H,D] -> [B,Sq,H,D]; softmax in f32."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = torch.where(mask, logits,
                             torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


# Blockwise (flash-style) attention: online softmax over key blocks, so
# the S x S logits are never materialized.  The dense path is used below
# this sequence-area threshold (the reference's branch, kept so the same
# shapes take the same summation order).
_BLOCKWISE_AREA = 2048 * 2048
_NEG = -1e30


def _block_mask(qpos, kpos, causal: bool, window: int) -> torch.Tensor:
    msk = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                     device=qpos.device)
    if causal:
        msk &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        msk &= kpos[None, :] > qpos[:, None] - window
    return msk


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, window=0, scale: float,
                        q_chunk: int = 512, k_chunk: int = 1024
                        ) -> torch.Tensor:
    """q:[B,Sq,H,D] k,v:[B,Sk,H,D] (H already GQA-expanded).  The
    reference's online softmax, q-chunk by q-chunk, each over the key
    chunks in order; f32 logits and statistics."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    q_chunk, k_chunk = min(q_chunk, sq), min(k_chunk, sk)
    if sq % q_chunk or sk % k_chunk:
        raise ValueError(f"chunks {q_chunk}, {k_chunk} must divide the "
                         f"sequences {sq}, {sk}")
    window = int(window)
    nq, nk = sq // q_chunk, sk // k_chunk
    qb = q.reshape(b, nq, q_chunk, h, d).permute(1, 0, 3, 2, 4)
    kb = k.reshape(b, nk, k_chunk, h, d).permute(1, 0, 3, 2, 4)
    vb = v.reshape(b, nk, k_chunk, h, d).permute(1, 0, 3, 2, 4)
    outs = []
    for qi in range(nq):
        qpos = qi * q_chunk + torch.arange(q_chunk, device=q.device)
        m = torch.full((b, h, q_chunk), _NEG, device=q.device)
        l = torch.zeros((b, h, q_chunk), device=q.device)
        acc = torch.zeros((b, h, q_chunk, d), device=q.device)
        for kj in range(nk):
            logits = torch.einsum("bhqd,bhkd->bhqk", qb[qi].float(),
                                  kb[kj].float()) * scale
            kpos = kj * k_chunk + torch.arange(k_chunk, device=q.device)
            msk = _block_mask(qpos, kpos, causal, window)
            logits = torch.where(msk[None, None], logits, _NEG)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(v.dtype).float(), vb[kj].float())
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b, sq, h, d)
    return out.to(v.dtype)


def _split_q6(q, n, c, g):
    b, s, h, d = q.shape
    return q.reshape(b, n, c, g, h // g, d).permute(1, 0, 3, 4, 2, 5)


def _merge_q6(x6):
    n, b, g, r, c, d = x6.shape
    return x6.permute(1, 0, 4, 2, 3, 5).reshape(b, n * c, g * r, d)


def _split5(x, n, c):
    b, s, h, d = x.shape
    return x.reshape(b, n, c, h, d).permute(1, 0, 3, 2, 4)


def flash_attention(q, k, v, window, causal: bool, scale: float,
                    q_chunk: int, k_chunk: int) -> torch.Tensor:
    """The forward of the reference's ``flash_attention``:
    q:[B,Sq,H,D]; k,v:[B,Sk,G,D] with G | H (grouped GQA, never expanded
    to H); ``window`` 0 = global.  Online softmax per q-chunk over the key
    chunks, ``p`` cast to v's dtype before the PV product as the
    reference does."""
    b, sq, h, d = q.shape
    sk, g = k.shape[1], k.shape[2]
    window = int(window)
    nq, nk = sq // q_chunk, sk // k_chunk
    q6 = _split_q6(q, nq, q_chunk, g)
    k5, v5 = _split5(k, nk, k_chunk), _split5(v, nk, k_chunk)
    r = h // g
    outs = []
    for qi in range(nq):
        qpos = qi * q_chunk + torch.arange(q_chunk, device=q.device)
        m = torch.full((b, g, r, q_chunk), _NEG, device=q.device)
        l = torch.zeros((b, g, r, q_chunk), device=q.device)
        acc = torch.zeros((b, g, r, q_chunk, d), device=q.device)
        for kj in range(nk):
            s = torch.einsum("bgrqd,bgkd->bgrqk", q6[qi].float(),
                             k5[kj].float()) * scale
            kpos = kj * k_chunk + torch.arange(k_chunk, device=q.device)
            msk = _block_mask(qpos, kpos, causal, window)
            s = torch.where(msk[None, None, None], s, _NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None]).to(v.dtype)
            l = l * corr + p.float().sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bgrqk,bgkd->bgrqd", p.float(), v5[kj].float())
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    return _merge_q6(torch.stack(outs).to(v.dtype))


def make_mask(sq: int, sk: int, *, causal: bool, window=0, offset: int = 0,
              device=None) -> Optional[torch.Tensor]:
    """[1,1,Sq,Sk] boolean mask (``None`` when nothing is masked).
    ``window`` 0 = no window (gemma3's per-layer local/global flag);
    ``offset`` = absolute position of query 0 minus position of key 0."""
    window = int(window)
    if not causal and window == 0:
        return None
    qpos = torch.arange(sq, device=device)[:, None] + offset
    kpos = torch.arange(sk, device=device)[None, :]
    m = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        m &= kpos <= qpos
    if window > 0:
        m &= kpos > qpos - window
    return m[None, None]


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, window=0, scale: float) -> torch.Tensor:
    """Dense vs flash attention by live-memory footprint (the reference's
    ``_BLOCKWISE_AREA`` branch).  ``k``/``v`` may have fewer (GQA) heads
    than ``q``: the dense path expands them, the flash path consumes them
    grouped."""
    sq, sk = q.shape[1], k.shape[1]
    n_rep = q.shape[2] // k.shape[2]
    if sq * sk > _BLOCKWISE_AREA and sq > 1:
        q_chunk = 512 if sq % 512 == 0 else math.gcd(sq, 512)
        k_chunk = 1024 if sk % 1024 == 0 else math.gcd(sk, 1024)
        return flash_attention(q, k, v, window, causal, scale, q_chunk,
                               k_chunk)
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    mask = make_mask(sq, sk, causal=causal, window=window,
                     offset=sk - sq if causal else 0, device=q.device)
    return attention_scores(q, k, v, mask=mask, scale=scale)


def _dense_mm(x: torch.Tensor, w: torch.Tensor, name: str = ""
              ) -> torch.Tensor:
    """Default projection matmul (the single-device path)."""
    return x @ w


def attention(params: Dict, x: torch.Tensor, *, n_heads: int,
              n_kv_heads: int, head_dim: int, positions: torch.Tensor,
              theta: float, causal: bool = True, window=0,
              mrope_sections: Optional[Tuple[int, int, int]] = None,
              kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              mm=None) -> torch.Tensor:
    """Full (training / prefill) attention.  x: [B, S, d].  ``mm``
    overrides the projection matmul (``dist.lm.dist_projection`` routes it
    onto the explicit ``(Pm, Pn, Pc)`` grid)."""
    mm = mm if mm is not None else _dense_mm
    b, s, _ = x.shape
    q = mm(x, params["wq"], "wq").reshape(b, s, n_heads, head_dim)
    pos2d = positions if positions.dim() == 2 else positions[:, 0]
    if kv_override is None:
        k = mm(x, params["wk"], "wk").reshape(b, s, n_kv_heads, head_dim)
        v = mm(x, params["wv"], "wv").reshape(b, s, n_kv_heads, head_dim)
        if mrope_sections is not None:
            q = apply_mrope(q, positions, theta, mrope_sections)
            k = apply_mrope(k, positions, theta, mrope_sections)
        else:
            q = apply_rope(q, pos2d, theta)
            k = apply_rope(k, pos2d, theta)
    else:
        k, v = kv_override  # cross attention (already projected)
        if mrope_sections is not None:
            q = apply_mrope(q, positions, theta, mrope_sections)
        else:
            q = apply_rope(q, pos2d, theta)
    out = attention_core(q, k, v, causal=causal, window=window,
                         scale=head_dim ** -0.5)
    return mm(out.reshape(b, s, n_heads * head_dim), params["wo"], "wo")


# ------------------------------------------------------------------ MLPs --

def init_mlp(generator, d_model: int, d_ff: int, act: str,
             dtype=torch.float32, device=None) -> Dict:
    kw = dict(dtype=dtype, device=device)
    p = {"w_up": _init(generator, (d_model, d_ff), **kw),
         "w_down": _init(generator, (d_ff, d_model), **kw)}
    if act in ("swiglu", "geglu"):
        p["w_gate"] = _init(generator, (d_model, d_ff), **kw)
    return p


def mlp(params: Dict, x: torch.Tensor, act: str, mm=None) -> torch.Tensor:
    mm = mm if mm is not None else _dense_mm
    up = mm(x, params["w_up"], "w_up")
    if act == "swiglu":
        h = F.silu(mm(x, params["w_gate"], "w_gate")) * up
    elif act == "geglu":
        h = gelu(mm(x, params["w_gate"], "w_gate")) * up
    else:
        h = gelu(up)
    return mm(h, params["w_down"], "w_down")


# ------------------------------------------------------------- embedding --

def init_embeddings(generator, vocab: int, d_model: int,
                    dtype=torch.float32, device=None) -> Dict:
    kw = dict(dtype=dtype, device=device)
    return {"tok": _init(generator, (vocab, d_model), scale=0.02, **kw),
            "lm_head": _init(generator, (d_model, vocab), **kw)}


def embed(emb: Dict, tokens: torch.Tensor) -> torch.Tensor:
    return emb["tok"][tokens.long()]

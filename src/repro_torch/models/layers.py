"""Shared neural layers: norms, RoPE/M-RoPE, GQA attention, MLPs, the
chunked vocabulary loss -- the port of ``repro/models/layers.py``.

Functional style: every layer is ``(params, inputs) -> outputs`` on
tensors, with an ``init_*`` companion that draws from an explicit
``torch.Generator``.  Attention masking supports causal, sliding-window
(gemma3 local layers) and bidirectional attention.  Computations
accumulate in f32 where it matters (norms, softmax, logits).  Attention is
plain torch code, written in the reference's summation order: the
reference has no Pallas kernel for it.  :func:`flash_attention` carries
the reference's custom VJP as a ``torch.autograd.Function``: it saves
``(q, k, v, out, lse)`` and its backward recomputes the probabilities per
(q, k) block pair.

The projection hook ``mm`` takes ``(x, w, name)``: ``name`` is the
parameter's key (``"wq"``, ``"w_up"``, ...), which ``dist.lm`` uses to tag
each routed projection's collectives; the reference's hook takes
``(x, w)``.

The GSPMD pins (``set_attention_mesh``, ``_shard_heads``,
``replicate_model``, ``shard_residual``) are the reference's sharding
constraints of its ``gspmd`` mode: once ``train.step.place_gspmd`` has set
a mesh, each redistributes a DTensor to its spec
(``dist.collectives.constrain``); without a mesh each is the identity.
Under a pinned mesh both branches of :func:`attention_core` expand k/v,
pin q/k/v heads over the model axis (where it splits the weights) and
run on each rank's blocks (``dist.collectives.local_map``), the flash
branch through :class:`_FlashAttention`; so do the projections
(:func:`_dense_mm`) and a decode step's scores against the cache
(:func:`cache_attention`): DTensor's sharding propagation splits no
product.  The port's own pins (``tp_residual``, ``tp_replicate``) keep
every product on each rank's share, as XLA splits it, and every view one
that torch 2.11's DTensor takes.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _init(generator: torch.Generator, shape, scale=None,
          dtype=torch.float32, device=None) -> torch.Tensor:
    """Normal draws from ``generator`` (on its own device) times
    ``scale`` (default ``shape[0] ** -0.5``, as the reference), as
    ``dtype`` on ``device``.  On the ``meta`` device nothing is drawn:
    the tensor has a shape and no storage."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
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
    stream = torch.tensor([i for i, n in enumerate(sections)
                           for _ in range(n)], device=x.device)  # [D/2]
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


def _merge5(x5):
    n, b, h, c, d = x5.shape
    return x5.permute(1, 0, 3, 2, 4).reshape(b, n * c, h, d)


def _flash_fwd(q, k, v, window: int, causal: bool, scale: float,
               q_chunk: int, k_chunk: int):
    """Online softmax per q-chunk over the key chunks, ``p`` cast to v's
    dtype before the PV product as the reference does.  Returns ``out``
    [B,Sq,H,D] in v's dtype and the log-sum-exp ``lse6``
    [nq,B,G,R,Qc] f32."""
    b, sq, h, d = q.shape
    sk, g = k.shape[1], k.shape[2]
    nq, nk = sq // q_chunk, sk // k_chunk
    q6 = _split_q6(q, nq, q_chunk, g)
    k5, v5 = _split5(k, nk, k_chunk), _split5(v, nk, k_chunk)
    r = h // g
    outs, lses = [], []
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
        l = torch.clamp(l, min=1e-30)
        outs.append(acc / l[..., None])
        lses.append(m + torch.log(l))
    return _merge_q6(torch.stack(outs).to(v.dtype)), torch.stack(lses)


def _flash_bwd(q, k, v, out, lse6, gr, window: int, causal: bool,
               scale: float, q_chunk: int, k_chunk: int):
    """The reference's ``_flash_bwd``: ``delta = sum(g * out)`` in f32;
    per q chunk a loop over the key chunks that accumulates dq, and dk /
    dv per key chunk in f32; GQA grouped (k, v never expanded); the masks
    applied before ``exp``."""
    b, sq, h, d = q.shape
    sk, g = k.shape[1], k.shape[2]
    nq, nk = sq // q_chunk, sk // k_chunk
    q6 = _split_q6(q, nq, q_chunk, g)
    k5, v5 = _split5(k, nk, k_chunk), _split5(v, nk, k_chunk)
    g6 = _split_q6(gr, nq, q_chunk, g)
    delta6 = (g6.float() * _split_q6(out, nq, q_chunk, g).float()).sum(-1)
    dk5 = torch.zeros((nk, b, g, k_chunk, d), device=q.device)
    dv5 = torch.zeros((nk, b, g, k_chunk, d), device=q.device)
    dqs = []
    for qi in range(nq):
        qpos = qi * q_chunk + torch.arange(q_chunk, device=q.device)
        q_blk, g_blk = q6[qi].float(), g6[qi].float()
        lse_blk, delta_blk = lse6[qi], delta6[qi]
        dq_blk = torch.zeros((b, g, h // g, q_chunk, d), device=q.device)
        for kj in range(nk):
            k_blk, v_blk = k5[kj].float(), v5[kj].float()
            s = torch.einsum("bgrqd,bgkd->bgrqk", q_blk, k_blk) * scale
            kpos = kj * k_chunk + torch.arange(k_chunk, device=q.device)
            msk = _block_mask(qpos, kpos, causal, window)
            s = torch.where(msk[None, None, None], s, _NEG)
            p = torch.exp(s - lse_blk[..., None]).to(v.dtype).float()
            dv_j = torch.einsum("bgrqk,bgrqd->bgkd", p, g_blk)
            dp = torch.einsum("bgrqd,bgkd->bgrqk", g_blk, v_blk)
            ds = (p * (dp - delta_blk[..., None]) * scale).to(
                v.dtype).float()
            dq_blk = dq_blk + torch.einsum("bgrqk,bgkd->bgrqd", ds, k_blk)
            dk5[kj] += torch.einsum("bgrqk,bgrqd->bgkd", ds, q_blk)
            dv5[kj] += dv_j
        dqs.append(dq_blk)
    return (_merge_q6(torch.stack(dqs)).to(q.dtype),
            _merge5(dk5).to(k.dtype), _merge5(dv5).to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    """The reference's ``flash_attention`` custom VJP: the residuals are
    ``(q, k, v, out, lse)`` -- O(S*D) -- and the backward recomputes the
    probabilities per (q, k) block pair."""

    @staticmethod
    def forward(ctx, q, k, v, window, causal, scale, q_chunk, k_chunk):
        out, lse6 = _flash_fwd(q, k, v, window, causal, scale, q_chunk,
                               k_chunk)
        ctx.save_for_backward(q, k, v, out, lse6)
        ctx.args = (window, causal, scale, q_chunk, k_chunk)
        return out

    @staticmethod
    def backward(ctx, gr):
        q, k, v, out, lse6 = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse6, gr.contiguous(),
                                *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, window, causal: bool, scale: float,
                    q_chunk: int, k_chunk: int) -> torch.Tensor:
    """The reference's ``flash_attention``: q:[B,Sq,H,D]; k,v:[B,Sk,G,D]
    with G | H (grouped GQA, never expanded to H); ``window`` 0 = global.
    Differentiable through :class:`_FlashAttention` when an input needs
    a gradient."""
    window = int(window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, window, causal, scale,
                                     q_chunk, k_chunk)
    return _flash_fwd(q, k, v, window, causal, scale, q_chunk, k_chunk)[0]


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


# Attention-internal sharding pins, set by ``train.step.place_gspmd``
# (the identity otherwise).  The reference pins the GQA-expanded k/v
# head-sharded because GSPMD's propagation through the repeat falls back
# to full replication; here the pins also give the flash branch the
# placements its per-rank blocks are computed under.
_ATTN_MESH = {"mesh": None, "dp": ()}


def set_attention_mesh(mesh, dp_axes=("pod", "data")):
    """Pin the attention, residual and MoE dispatch tensors to ``mesh``
    (a ``DeviceMesh``, or an ``{axis: extent}`` mapping for the specs
    alone), the batch over the ``dp_axes`` of extent > 1; ``None``
    unpins."""
    from repro_torch.parallel.sharding import mesh_shape
    shape = mesh_shape(mesh) if mesh is not None else {}
    _ATTN_MESH["mesh"] = mesh
    _ATTN_MESH["dp"] = tuple(a for a in dp_axes if shape.get(a, 1) > 1)


def _mesh_size(axis: str) -> int:
    from repro_torch.parallel.sharding import mesh_shape
    return mesh_shape(_ATTN_MESH["mesh"]).get(axis, 1)


def _model_free() -> bool:
    """True when the model axis is NOT already carrying batch (pure-DP
    regimes fold it into dp)."""
    return "model" not in _ATTN_MESH["dp"]


def _dp_size() -> int:
    return math.prod(_mesh_size(a) for a in _ATTN_MESH["dp"])


def _b_spec(batch: int):
    dp = _ATTN_MESH["dp"]
    if dp and batch % _dp_size() == 0:
        return dp if len(dp) > 1 else dp[0]
    return None


def _batch_blocks(batch: int, skip=()) -> Optional[object]:
    """The spec entry of a product's batch rows on each rank: the data
    axes (not in ``skip``) in order, each that divides what the ones
    before it leave (``parallel.sharding.batch_specs``'s rule).  The
    reference's pins (:func:`_b_spec`) hold a batch whole unless every
    data axis divides it; XLA still splits the products between two pins
    so, and gathers the batch at the pin."""
    use, rem = [], batch
    for a in _ATTN_MESH["dp"]:
        if a not in skip and rem % _mesh_size(a) == 0:
            use.append(a)
            rem //= _mesh_size(a)
    return None if not use else use[0] if len(use) == 1 else tuple(use)


def _heads_spec(shape, batch_sharded: bool = True) -> tuple:
    """The pin of [B, S, H, D]: (dp, None, model, None) where divisible."""
    m = _mesh_size("model")
    h_spec = "model" if (m > 1 and shape[2] % m == 0
                         and _model_free()) else None
    return (_b_spec(shape[0]) if batch_sharded else None, None, h_spec,
            None)


def _replicate_spec(shape) -> tuple:
    """Batch over the data axes, replicated over the model axis."""
    return (_b_spec(shape[0]),) + (None,) * (len(shape) - 1)


def _residual_spec(shape) -> tuple:
    """[B, S, d]: batch over data, the sequence over model."""
    m = _mesh_size("model")
    s_spec = "model" if (m > 1 and shape[1] % m == 0
                         and _model_free()) else None
    return (_b_spec(shape[0]), s_spec, None)


def _pin(x: torch.Tensor, spec: tuple, tag: str) -> torch.Tensor:
    from repro_torch.dist.collectives import constrain
    return constrain(x, _ATTN_MESH["mesh"], spec, tag=tag)


def _shard_heads(x: torch.Tensor, batch_sharded: bool = True
                 ) -> torch.Tensor:
    """Constrain [B, S, H, D] to (dp, None, model, None) when divisible."""
    if _ATTN_MESH["mesh"] is None:
        return x
    return _pin(x, _heads_spec(x.shape, batch_sharded), "heads")


def replicate_model(x: torch.Tensor) -> torch.Tensor:
    """Pin a tensor to batch-over-data, replicated over the model axis
    (the reference's pin around tiny sequential recurrences, where any
    model-axis sharding costs a per-timestep psum)."""
    if _ATTN_MESH["mesh"] is None or x.dim() < 2:
        return x
    return _pin(x, _replicate_spec(x.shape), "replicate_model")


def shard_residual(x: torch.Tensor) -> torch.Tensor:
    """Sequence-shard the residual stream [B, S, d] over the model axis
    (the Megatron-SP analogue): per-block psums become reduce-scatters
    and norms run on 1/TP of the tokens.  The identity without a pinned
    mesh or unless x is [B, S, d]."""
    if _ATTN_MESH["mesh"] is None or x.dim() != 3:
        return x
    return _pin(x, _residual_spec(x.shape), "residual")


def _tp() -> bool:
    """True under a pinned mesh whose model axis splits the weights (it
    has more than one rank and carries no batch)."""
    return (_ATTN_MESH["mesh"] is not None and _model_free()
            and _mesh_size("model") > 1)


def tp_residual(x: torch.Tensor) -> torch.Tensor:
    """:func:`shard_residual` where the model axis splits the weights
    (:func:`_tp`), else ``x`` itself.  Pinned at each sub-block, the
    residual gives every projection its rows as XLA does, and no model
    rank repeats a product that the others split.  Under pure data
    parallelism the pin would make a residual whose batch the data axes
    do not divide whole on every rank: there it is left to DTensor."""
    return shard_residual(x) if _tp() else x


def tp_replicate(x: torch.Tensor) -> torch.Tensor:
    """:func:`replicate_model` where the model axis splits the weights
    (:func:`_tp`), else ``x`` itself (see :func:`tp_residual`)."""
    return replicate_model(x) if _tp() else x


def _block_offset(mesh, entry, local_len: int) -> int:
    """Where this rank's block of a dim placed by spec ``entry`` starts:
    its coordinate over the entry's axes (major first) times the block's
    length."""
    from repro_torch.dist.collectives import _spec_axes, axis_index, \
        axis_size
    idx = 0
    for a in _spec_axes(entry):
        idx = idx * axis_size(mesh, a) + axis_index(mesh, a)
    return idx * local_len


def write_rows(cache: torch.Tensor, new: torch.Tensor,
               pos: Optional[torch.Tensor] = None) -> None:
    """Write ``new`` [B,n,...] into ``cache`` [B,Smax,...] in place: into
    its first ``n`` rows when ``pos`` is None (a prompt), else one row per
    batch element at ``pos`` [B] (``n == 1``, a decode step).

    On a placed cache (a DTensor, whose sequence dim the serve specs
    shard over the model axis) each rank writes, through
    ``collectives.local_map``, the rows that fall in its own block:
    ``new`` and ``pos`` are pinned batch-like the cache and whole along
    the sequence, so the write needs no gather and moves no cache row."""
    from repro_torch.dist import collectives as C
    if not C.is_placed(cache):
        if pos is None:
            cache[:, :new.shape[1]] = new
        else:
            rows = torch.arange(cache.shape[0], device=cache.device)
            cache[rows, pos.long()] = new[:, 0]
        return
    mesh = cache.device_mesh
    spec = C.spec_of(cache)
    new_spec = (spec[0], None) + tuple(spec[2:])
    new = C.constrain(new, mesh, new_spec, tag="cache_write")
    n_all = new.shape[1]

    def local(c, x, p=None):
        sl = c.shape[1]
        off = _block_offset(mesh, spec[1], sl)
        if p is None:
            n = min(max(n_all - off, 0), sl)
            if n:
                c[:, :n] = x[:, off:off + n]
            return c
        idx = p.long() - off
        inside = ((idx >= 0) & (idx < sl)).view((-1,) + (1,) * (x.dim()
                                                                 - 2))
        rows = torch.arange(c.shape[0], device=c.device)
        idx = idx.clamp(0, sl - 1)
        c[rows, idx] = torch.where(inside, x[:, 0], c[rows, idx])
        return c

    args, specs = [cache, new], [spec, new_spec]
    if pos is not None:
        pos_spec = (spec[0],)
        pos = (C.constrain(pos, mesh, pos_spec, tag="cache_write")
               if C.is_placed(pos) else C.place(pos, mesh, pos_spec))
        args.append(pos)
        specs.append(pos_spec)
    C.local_map(local, mesh, tuple(specs), spec)(*args)


def _on_head_blocks(fn, q, k, v):
    """``fn(q, k, v)`` on each rank's blocks under the pinned mesh: q and
    the GQA-expanded k/v pinned heads over model (batch-only where the
    heads do not divide), whose heads and batch rows are independent."""
    from repro_torch.dist.collectives import constrain, local_map
    mesh = _ATTN_MESH["mesh"]
    n_rep = q.shape[2] // k.shape[2]
    q = _shard_heads(q)
    k = _shard_heads(_repeat_kv(k, n_rep))
    v = _shard_heads(_repeat_kv(v, n_rep))
    spec = _heads_spec(q.shape)
    if spec[0] is None:     # a batch the pin holds whole: split it
        spec = (_batch_blocks(q.shape[0], skip=(spec[2],)),) + spec[1:]
        q, k, v = (constrain(t, mesh, spec, tag="batch_blocks")
                   for t in (q, k, v))
    return local_map(fn, mesh, (spec, spec, spec), spec)(q, k, v)


def _pinned_flash(q, k, v, window, causal, scale, q_chunk, k_chunk):
    """The flash branch under a pinned mesh: :class:`_FlashAttention` on
    each rank's head blocks (:func:`_on_head_blocks`)."""
    return _on_head_blocks(
        lambda ql, kl, vl: flash_attention(ql, kl, vl, window, causal,
                                           scale, q_chunk, k_chunk),
        q, k, v)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, window=0, scale: float) -> torch.Tensor:
    """Dense vs flash attention by live-memory footprint (the reference's
    ``_BLOCKWISE_AREA`` branch).  ``k``/``v`` may have fewer (GQA) heads
    than ``q``: the dense path expands them; the flash path consumes them
    grouped, or expanded and pinned under a pinned mesh."""
    sq, sk = q.shape[1], k.shape[1]
    n_rep = q.shape[2] // k.shape[2]
    if sq * sk > _BLOCKWISE_AREA and sq > 1:
        q_chunk = 512 if sq % 512 == 0 else math.gcd(sq, 512)
        k_chunk = 1024 if sk % 1024 == 0 else math.gcd(sk, 1024)
        if _ATTN_MESH["mesh"] is not None:
            return _pinned_flash(q, k, v, window, causal, scale, q_chunk,
                                 k_chunk)
        return flash_attention(q, k, v, window, causal, scale, q_chunk,
                               k_chunk)
    mask = make_mask(sq, sk, causal=causal, window=window,
                     offset=sk - sq if causal else 0, device=q.device)
    if _ATTN_MESH["mesh"] is not None:
        return _pinned_dense(q, k, v, mask, scale)
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    return attention_scores(q, k, v, mask=mask, scale=scale)


def _pinned_dense(q, k, v, mask, scale):
    """The dense branch under a pinned mesh: the scores on each rank's
    head blocks (:func:`_on_head_blocks`; under pure data parallelism the
    heads are whole and the batch rows split), so DTensor's propagation
    chooses no split of the two products.  DTensor's own einsum also
    flattens the batch and head dims into one, which torch 2.11 refuses
    while both are split."""
    return _on_head_blocks(
        lambda ql, kl, vl: attention_scores(ql, kl, vl, mask=mask,
                                            scale=scale), q, k, v)


def cache_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    mask: Optional[torch.Tensor], scale: float
                    ) -> torch.Tensor:
    """:func:`attention_scores` of decode queries q [B,1,H,D] against a
    cache's K/V [B,Sk,G,D] (GQA-expanded here).  On a placed cache (the
    serve specs split its batch over data and its keys over model) both
    products run on each rank's blocks (``collectives.local_map``): q
    whole over the axes that split the keys, the scores split along the
    keys, the softmax on them as DTensor places it, the probabilities cut
    back to the keys' blocks (a slice: no wire) and the values' product a
    pending sum over the keys' axes, as flash decoding splits it."""
    from repro_torch.dist import collectives as C
    n_rep = q.shape[2] // k.shape[2]
    if not C.is_placed(k):
        return attention_scores(q, _repeat_kv(k, n_rep),
                                _repeat_kv(v, n_rep), mask=mask,
                                scale=scale)
    mesh = k.device_mesh
    b_spec, k_spec = C.spec_of(k)[:2]
    kv_spec = (b_spec, k_spec, None, None)
    q_spec = (b_spec, None, None, None)
    p_spec = (b_spec, None, None, k_spec)
    q = C.constrain(q, mesh, q_spec, tag="cache_query")
    k = C.constrain(k, mesh, kv_spec, tag="cache_keys")
    v = C.constrain(v, mesh, kv_spec, tag="cache_keys")
    k_axes = C._spec_axes(k_spec)

    def scores(ql, kl):
        return torch.einsum("bqhd,bkhd->bhqk", ql.float(),
                            _repeat_kv(kl, n_rep).float()) * scale

    def values(pl, vl):
        return torch.einsum("bhqk,bkhd->bqhd", pl,
                            _repeat_kv(vl, n_rep))

    logits = C.local_map(scores, mesh, (q_spec, kv_spec), p_spec,
                         grad_sum_axes=[k_axes, ()])(q, k)
    if mask is not None:
        logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    probs = C.constrain(torch.softmax(logits, dim=-1).to(v.dtype), mesh,
                        p_spec, tag="cache_probs")
    return C.local_map(values, mesh, (p_spec, kv_spec), q_spec,
                       out_sum_axes=k_axes)(probs, v)


def split_heads(x: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """``x`` [..., n * d] as [..., n, d].  A placed ``x`` whose last dim is
    split into blocks that do not hold whole heads (``n`` not a multiple
    of the blocks: 15 heads over a model axis of 16) is first gathered
    along it (``collectives.whole_along``); DTensor cannot split a
    sharded dim unevenly, where XLA pads."""
    from repro_torch.dist.collectives import axis_size, shard_axes, \
        whole_along
    axes = shard_axes(x, -1)
    if n % math.prod(axis_size(x.device_mesh, a) for a in axes):
        x = whole_along(x, -1, tag="split_heads")
    return x.reshape(*x.shape[:-1], n, d)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """``x`` [..., n, d] as [..., n * d].  Under a pinned mesh whose model
    axis does not divide ``n``, the merged gradient is made whole along
    its last dim before it flows back into the merge: its backward splits
    that dim into the ``n`` heads, which a block of ``n * d / model``
    features does not hold (:func:`split_heads`' case, backward)."""
    n, d = x.shape[-2:]
    out = x.reshape(*x.shape[:-2], n * d)
    if _ATTN_MESH["mesh"] is not None and n % _mesh_size("model"):
        from repro_torch.dist.collectives import grad_whole_along
        out = grad_whole_along(out, -1, tag="merge_heads")
    return out


def _entry(axes):
    """The spec entry of a dim split over ``axes`` (in the mesh's order)."""
    axes = tuple(axes)
    return None if not axes else axes[0] if len(axes) == 1 else axes


def _dense_mm(x: torch.Tensor, w: torch.Tensor, name: str = ""
              ) -> torch.Tensor:
    """Default projection matmul (the single-device path).  On a placed
    ``x`` and ``w`` the product runs on each rank's blocks
    (``collectives.local_map``), in the form the weight's placement
    gives, as XLA splits a projection:

    * column-parallel (``w``'s columns over model): ``x``'s rows whole
      over model (a sequence-split residual is gathered), its features
      whole; the output's columns over model, ``x``'s gradient a pending
      sum over model;
    * row-parallel (``w``'s rows over model): ``x``'s features split over
      model to match (a slice of each rank's block where ``x`` is whole
      there, a reduce-scatter where it is a pending sum); the output a
      pending sum over model, which the next residual pin settles (a
      reduce-scatter into the sequence-split residual);
    * data parallel (``w`` whole over model): ``x``'s rows as the
      residual's pin splits them over model (its sequence), else its
      features as a column-parallel producer split them (a slice of the
      weight's rows, the output a pending sum).

    The batch rows are split over every data axis that divides them
    (:func:`_batch_blocks`); no other split of ``x``, DTensor's choice,
    is read, so no torch version changes the product's split.  A weight
    that FSDP splits over a data axis is gathered there when the rows
    take that axis; else it keeps its split, and the product splits its
    contraction (a pending sum) or its columns there, as XLA does for a
    decode step's rows.  The weight's gradient is a pending sum over the
    axes that split the rows.  No view of a placed tensor is taken, and
    DTensor's propagation chooses no split of the product."""
    from repro_torch.dist import collectives as C
    if not (C.is_placed(x) and C.is_placed(w)):
        return x @ w
    mesh = w.device_mesh
    w_in, w_out = (C._spec_axes(e) for e in C.spec_of(w))
    tp = "model" in w_in + w_out
    # x's split over a model axis that neither the batch nor the weight
    # takes: the tensor-parallel residual's pin, or its producer's
    free = ("model",) if "model" not in _ATTN_MESH["dp"] and not tp \
        else ()
    xspec = tuple(_entry(a for a in C._spec_axes(e) if a in free)
                  for e in C.spec_of(x, pending_as_replica=True))
    rows = (_batch_blocks(x.shape[0], skip=("model",) if tp else ()),
            ) + xspec[1:-1]
    taken = {a for e in rows for a in C._spec_axes(e)}
    w_in = tuple(a for a in w_in if a not in taken)
    w_out = tuple(a for a in w_out if a not in taken)
    if not w_in:
        w_in = tuple(a for a in C._spec_axes(xspec[-1]) if a not in taken)
    wspec = (_entry(w_in), _entry(w_out))
    w = C.constrain(w, mesh, wspec, tag="fsdp_gather")
    xspec = rows + (wspec[0],)
    x = C.constrain(x, mesh, xspec, tag="mm_in")
    return C.local_map(torch.matmul, mesh, (xspec, wspec),
                       rows + (wspec[1],),
                       grad_sum_axes=[w_out, tuple(taken)],
                       out_sum_axes=w_in)(x, w)


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
    q = split_heads(mm(x, params["wq"], "wq"), n_heads, head_dim)
    pos2d = positions if positions.dim() == 2 else positions[:, 0]
    if kv_override is None:
        k = split_heads(mm(x, params["wk"], "wk"), n_kv_heads, head_dim)
        v = split_heads(mm(x, params["wv"], "wv"), n_kv_heads, head_dim)
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
    return mm(merge_heads(out), params["wo"], "wo")


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
    """The rows of ``emb["tok"]`` at ``tokens``; placed tokens look up
    each rank's block of the table (:func:`_placed_embed`), the result
    pinned as the residual (:func:`tp_residual`): a table whose
    ``d_model`` the FSDP rules split over data would otherwise leave the
    first layer's norm with ``d_model`` split over data and the batch
    whole, and its backward sums that torch 2.11's DTensor cannot
    place."""
    from repro_torch.dist.collectives import is_placed
    if is_placed(tokens):
        return tp_residual(_placed_embed(emb["tok"], tokens))
    return emb["tok"][tokens.long()]


def _placed_embed(table, tokens):
    """The lookup on each rank's blocks (``collectives.local_map``), as
    Megatron's vocab-parallel embedding: the tokens made whole over the
    mesh axes that split the table, each rank's rows at the tokens its
    vocabulary block holds (zeros elsewhere), summed over the vocabulary's
    axes; the table's ``d_model`` split stays the output's.  DTensor's own
    rules for the lookup gather the table (torch 2.13) or fail on indices
    split over two mesh axes (torch 2.11, pure data parallelism)."""
    from repro_torch.dist import collectives as C
    vocab = C.shard_axes(table, 0)
    tokens = C.whole_along(tokens, 0, tag="embed",
                           axes=vocab + C.shard_axes(table, 1))
    mesh = table.device_mesh
    t_spec, x_spec = C.spec_of(table), C.spec_of(tokens)
    batch = tuple(a for e in x_spec for a in C._spec_axes(e))

    def local(tab, x):
        rows = tab.shape[0]
        idx = x.long() - _block_offset(mesh, t_spec[0], rows)
        inside = (idx >= 0) & (idx < rows)
        out = tab[idx.clamp(0, rows - 1)]
        return out * inside[..., None].to(out.dtype)

    out = C.local_map(local, mesh, (t_spec, x_spec), x_spec + t_spec[1:],
                      grad_sum_axes=[batch, ()], out_sum_axes=vocab)
    return C.settle(out(table, tokens), tag="embed")


def chunked_cross_entropy(h: torch.Tensor, lm_head: torch.Tensor,
                          labels: torch.Tensor, *, chunk: int = 512
                          ) -> torch.Tensor:
    """Mean token cross-entropy without the full [B,S,V] logits: a loop
    over sequence chunks of ``min(chunk, S)``, each with f32 logits
    ``hx @ lm_head``, their log-sum-exp and the target picked by a masked
    sum over the vocabulary (the reference's, which reduces over a
    vocabulary its GSPMD mode may shard); the chunk sums accumulated in
    f32 in chunk order, over ``B * S``.  h: [B,S,d], labels: [B,S]."""
    b, s, _ = h.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"chunk {chunk} must divide the sequence {s}")
    vocab = torch.arange(lm_head.shape[1], device=h.device)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s, chunk):
        logits = _dense_mm(h[:, c0:c0 + chunk], lm_head).float()  # [B,c,V]
        lse = torch.logsumexp(logits, dim=-1)
        sel = vocab == labels[:, c0:c0 + chunk, None]
        tgt = torch.where(sel, logits, 0.0).sum(dim=-1)
        total = total + (lse - tgt).sum()
    return total / (b * s)


def remat(fn, on: bool):
    """``fn`` under activation checkpointing when ``on`` and autograd is
    recording -- ``torch.utils.checkpoint`` (non-reentrant) keeps the
    inputs and recomputes the rest in the backward, as the reference's
    ``jax.checkpoint`` of a layer's body does -- else ``fn`` itself."""
    if not on:
        return fn

    def run(*args, **kw):
        if not torch.is_grad_enabled():
            return fn(*args, **kw)
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return run

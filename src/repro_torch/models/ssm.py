"""State-space / recurrent blocks: Mamba2 (SSD), mLSTM, sLSTM -- the port
of ``repro/models/ssm.py``.

Mamba2 and mLSTM share the chunked linear-recurrence template

    S_t = exp(lf_t) * S_{t-1} + exp(li_t) * k_t v_t^T
    y_t = q_t . S_t

computed in the chunkwise-parallel form (intra-chunk masked attention +
inter-chunk carried state, log-space decays): a Python loop over chunks
here, the reference's ``lax.scan``.  Decode is the single-step
recurrence on the carried state, which :func:`linear_recurrence_step`
updates in place (a cache's own tensor) where the reference returns a new
array.  sLSTM runs as a loop over time with per-head block-diagonal
recurrence.  The einsums, gates and states are float32 wherever the
reference casts, also under bfloat16 weights.

The reference's two ``jax.custom_vjp`` rules are
``torch.autograd.Function``s here, taken when an input needs a gradient:
:class:`_ClrScan` saves the chunk-boundary states only and recomputes
each chunk in reverse; :class:`_SlstmScan` accumulates the recurrent
weight's gradient per batch element and sums over the batch once after
the loop.  The in-place decode update is never on that path: training
runs the chunked form on fresh states.

Under the GSPMD pins (``layers.set_attention_mesh``, set by
``train.step.place_gspmd``) both recurrences run on each rank's blocks
through ``dist.collectives.local_map``, as the pinned flash branch does:
their inputs pinned batch over the data axes and replicated over model
(the chunked recurrence's heads over model where it divides them, as XLA
splits them), the ``Function`` or the no-grad loop on plain blocks, the
outputs placed the same way (:func:`_pinned_recurrence`).  The reference
leaves this to XLA's propagation through its two custom VJPs; the pins
are the port's own, and they change no value.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.layers import _init

# ------------------------------------------------------ under a pinned mesh --

def _pinned_recurrence(local, ins, out_shapes, weights: int = 0,
                       heads=None):
    """``local(*ins)`` on each rank's blocks under the pinned mesh, as
    the pinned flash branch runs (``layers._pinned_flash``): each input
    pinned batch over the data axes and replicated over model
    (``layers.replicate_model``'s spec; a batch that spec holds whole
    split over the data axes that divide it, ``layers._batch_blocks``),
    its outputs (of the global ``out_shapes``) placed the same way.
    Sound because the batch rows of both recurrences are independent.
    ``heads`` names the dim that holds the heads, in each input and then
    in each output: where the
    model axis divides them (and carries no batch), that dim goes over
    model too, as XLA splits the chunked recurrence's heads; its heads
    are independent as well.  ``ins[1:1 + weights]`` are weights shared
    by every row (the sLSTM's ``r`` and ``bias``): pinned whole on every
    rank, and their gradient a pending sum over the axes that split the
    batch."""
    from repro_torch.dist.collectives import local_map
    shared = range(1, 1 + weights)
    shapes = [tuple(t.shape) for t in ins] + [tuple(s) for s in out_shapes]
    specs = [(None,) * len(shape) if i in shared
             else layers._replicate_spec(shape)
             for i, shape in enumerate(shapes)]
    m, tag = layers._mesh_size("model"), "replicate_model"
    if heads is not None and m > 1 and layers._model_free() and all(
            shape[d] % m == 0 for shape, d in zip(shapes, heads)):
        specs = [spec[:d] + ("model",) + spec[d + 1:]
                 for spec, d in zip(specs, heads)]
        tag = "recurrence_heads"
    bspec = layers._b_spec(ins[0].shape[0])
    if bspec is None:   # a batch the pin holds whole: split it
        bspec = layers._batch_blocks(
            ins[0].shape[0], skip=("model",) if tag != "replicate_model"
            else ())
        specs = [spec if i in shared else (bspec,) + spec[1:]
                 for i, spec in enumerate(specs)]
    in_specs, out_specs = specs[:len(ins)], specs[len(ins):]
    pinned = [layers._pin(t, spec, tag) for t, spec in zip(ins, in_specs)]
    axes = () if bspec is None else (
        (bspec,) if isinstance(bspec, str) else tuple(bspec))
    grad_axes = [axes if i in shared else () for i in range(len(ins))]
    return local_map(local, layers._ATTN_MESH["mesh"], in_specs, out_specs,
                     grad_sum_axes=grad_axes)(*pinned)


# ----------------------------------------------------------- chunked CLR --


def _clr_body(S, xs, causal):
    """One chunk of the linear recurrence.  ``xs`` = (q, k [B,c,H,N],
    v [B,c,H,P], lf, li [B,c,H] f32); ``S`` [B,H,N,P] f32."""
    qx, kx, vx, lfx, lix = xs
    qf, kf, vf = qx.float(), kx.float(), vx.float()
    L = torch.cumsum(lfx, dim=1)                     # [B,c,H] inclusive
    Ltot = L[:, -1:, :]                              # [B,1,H]
    # intra-chunk: scores[i,j] = (q_i.k_j) exp(L_i - L_j + li_j), j<=i
    qk = torch.einsum("bihn,bjhn->bhij", qf, kf)
    Lh, lih = L.permute(0, 2, 1), lix.permute(0, 2, 1)          # [B,H,c]
    decay = Lh[:, :, :, None] - Lh[:, :, None, :] + lih[:, :, None, :]
    # mask before exp: above the diagonal the decay can overflow, and
    # inf * 0 after the exp would be NaN
    scores = qk * torch.exp(torch.where(causal, decay, -torch.inf))
    scores = torch.where(causal, scores, 0.0)
    y_intra = torch.einsum("bhij,bjhp->bihp", scores, vf)
    # inter-chunk: y_i += exp(L_i) q_i . S_prev
    y_inter = torch.einsum("bihn,bhnp->bihp", qf * torch.exp(L)[..., None],
                           S)
    # state update: S = exp(Ltot) S + sum_j exp(Ltot - L_j + li_j) k_j v_j^T
    w = torch.exp(Ltot - L + lix)                    # [B,c,H]
    S_new = S * torch.exp(Ltot).permute(0, 2, 1)[..., None]
    S_new = S_new + torch.einsum("bjhn,bjhp->bhnp", kf * w[..., None], vf)
    return S_new, y_intra + y_inter


def _clr_chunks(q, k, v, lf, li, S, chunk: int):
    """The chunk loop: (y [B,S,H,P] f32, final state, the state entering
    each chunk)."""
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=q.device).tril()
    ys, s_ins = [], []
    for c0 in range(0, q.shape[1], chunk):
        c = slice(c0, c0 + chunk)
        s_ins.append(S)
        S, y = _clr_body(S, (q[:, c], k[:, c], v[:, c], lf[:, c], li[:, c]),
                         causal)
        ys.append(y)
    return torch.cat(ys, dim=1), S, s_ins


class _ClrScan(torch.autograd.Function):
    """The reference's ``_clr_scan`` custom VJP: the residuals are the
    inputs and the state entering each chunk; the backward walks the
    chunks in reverse, recomputing each chunk's body to differentiate
    it (the default VJP would keep every chunk's O(chunk^2) scores)."""

    @staticmethod
    def forward(ctx, q, k, v, lf, li, S0, chunk):
        y, S, s_ins = _clr_chunks(q, k, v, lf, li, S0, chunk)
        ctx.save_for_backward(q, k, v, lf, li, *s_ins)
        ctx.chunk = chunk
        return y, S

    @staticmethod
    def backward(ctx, dy, dS):
        q, k, v, lf, li, *s_ins = ctx.saved_tensors
        chunk = ctx.chunk
        causal = torch.ones((chunk, chunk), dtype=torch.bool,
                            device=q.device).tril()
        grads = []
        dS = dS.float()
        for i in reversed(range(len(s_ins))):
            c = slice(i * chunk, (i + 1) * chunk)
            ins = [t.detach().requires_grad_(True)
                   for t in (s_ins[i], q[:, c], k[:, c], v[:, c], lf[:, c],
                             li[:, c])]
            with torch.enable_grad():
                S_new, y = _clr_body(ins[0], tuple(ins[1:]), causal)
                dS, *g = torch.autograd.grad((S_new, y), ins,
                                             (dS, dy[:, c]))
            grads.append(g)
        dq, dk, dv, dlf, dli = (torch.cat(parts[::-1], dim=1)
                                for parts in zip(*grads))
        return dq, dk, dv, dlf, dli, dS, None


def _clr(q, k, v, lf, li, S, chunk):
    """(y [B,S,H,P] f32, final state) of the chunk loop from state ``S``:
    through :class:`_ClrScan` when an input needs a gradient."""
    ins = (q, k, v, lf, li, S)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        return _ClrScan.apply(*ins, chunk)
    y, S, _ = _clr_chunks(*ins, chunk)
    return y, S


def chunked_linear_recurrence(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, lf: torch.Tensor,
                              li: torch.Tensor, *, chunk: int,
                              state0: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q,k: [B,S,H,N]; v: [B,S,H,P]; lf,li: [B,S,H] (log gates, lf<=0).

    Returns (y [B,S,H,P] in v's dtype, final_state [B,H,N,P] f32).
    ``state0`` is read, never written.  Differentiable through
    :class:`_ClrScan` when an input needs a gradient.  Under a pinned
    mesh (:func:`_pinned_recurrence`) it runs on each rank's blocks."""
    b, s, h, n = q.shape
    p = v.shape[-1]
    chunk = min(chunk, s)
    assert s % chunk == 0, (s, chunk)
    lf, li = lf.float(), li.float()

    def local(ql, kl, vl, lfl, lil, s0=None):
        # this rank's rows and heads
        S = (torch.zeros(ql.shape[:1] + ql.shape[2:3] + (n, p),
                         dtype=torch.float32, device=ql.device)
             if s0 is None else s0.float())
        y, S = _clr(ql, kl, vl, lfl, lil, S, chunk)
        return y.to(vl.dtype), S

    ins = (q, k, v, lf, li) + (() if state0 is None else (state0,))
    if layers._ATTN_MESH["mesh"] is not None:
        # the heads: dim 2 of q, k, v, lf, li and y, dim 1 of the states
        return _pinned_recurrence(local, ins, [(b, s, h, p), (b, h, n, p)],
                                  heads=(2,) * 5 + (1,) * (len(ins) - 5)
                                  + (2, 1))
    return local(*ins)


def linear_recurrence_step(q, k, v, lf, li, state):
    """One decode step.  q,k: [B,H,N]; v: [B,H,P]; lf,li: [B,H];
    state: [B,H,N,P].  Returns (y [B,H,P] in v's dtype, new_state).

    A contiguous float32 ``state`` is updated in place and returned (two
    passes over it, and one more to read ``y``); any other is first
    copied to float32, as the reference casts."""
    from repro_torch.dist import collectives as C
    if C.is_placed(state):
        return _placed_step(q, k, v, lf, li, state)
    b, h, n = k.shape
    p = v.shape[-1]
    if state.dtype != torch.float32 or not state.is_contiguous():
        state = state.float().contiguous()
    f = torch.exp(lf.float())[..., None, None]
    i = torch.exp(li.float())[..., None]
    state.mul_(f)
    state.view(b * h, n, p).baddbmm_(
        (k.float() * i).reshape(b * h, n, 1),
        v.float().reshape(b * h, 1, p))
    y = torch.matmul(q.float()[..., None, :], state)[..., 0, :]
    return y.to(v.dtype), state


def _placed_step(q, k, v, lf, li, state):
    """:func:`linear_recurrence_step` on a placed state (the serve specs
    shard its heads over the model axis): every input pinned as the
    state's batch and heads, and the step run on each rank's blocks
    (``collectives.local_map``), whose heads and rows are independent; the
    state's block is updated in place, so the placed state is returned
    as it came."""
    from repro_torch.dist import collectives as C
    if state.dtype != torch.float32:
        raise TypeError(f"a placed recurrent state is updated in place: it "
                        f"must be float32, not {state.dtype}")
    mesh = state.device_mesh
    st_spec = C.spec_of(state)
    specs = [st_spec[:3], st_spec[:3], st_spec[:3], st_spec[:2],
             st_spec[:2]]
    ins = [C.constrain(t, mesh, sp, tag="state_step") if C.is_placed(t)
           else C.place(t, mesh, sp) for t, sp in zip((q, k, v, lf, li),
                                                      specs)]

    def local(ql, kl, vl, lfl, lil, sl):
        y, s_new = linear_recurrence_step(ql, kl, vl, lfl, lil, sl)
        assert s_new is sl, "the local state block was not contiguous"
        return y

    y = C.local_map(local, mesh, tuple(specs) + (st_spec,),
                    st_spec[:3])(*ins, state)
    return y, state


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA evaluates it, ``x * (1 / (1 + exp(-x)))``
    with every step rounded to ``x``'s dtype: in bfloat16 it equals the
    reference's to the bit, where ``F.silu`` rounds once (a 2^-8 step
    apart on a third of the inputs, which six Mamba2 layers amplify to
    8e-2 of max|logit| against the reference)."""
    return x * (1 / (1 + torch.exp(-x)))


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``, ``-logaddexp(-x, 0)``: the same operations
    as ``F.logsigmoid``'s ``min(x, 0) - log1p(exp(-|x|))``, in ops that
    DTensor differentiates (it has no rule for ``log_sigmoid_backward``)."""
    return -torch.logaddexp(-x, torch.zeros_like(x))


def _gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    yf = y.float() * _silu(z.float())
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    yf = yf * torch.rsqrt(var + eps) * (1.0 + w.float())
    return yf.to(y.dtype)


def write_back(stack: Dict, i: int, st_in: Dict, st_out: Dict) -> None:
    """Store layer ``i``'s new states in the stacked ``stack``: every
    state a block returned as a new tensor is copied in; one it updated
    in place (the decode step's SSD state) is already there."""
    for key, new in st_out.items():
        if new is not st_in[key]:
            stack[key][i].copy_(new)


# --------------------------------------------------------------- Mamba2 ---

def init_mamba2(generator, d_model: int, *, expand: int, state: int,
                head_dim: int, dtype=torch.bfloat16, device=None) -> Dict:
    di = expand * d_model
    nh = di // head_dim
    kw = dict(dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_z": _init(generator, (d_model, di), **kw),
        "w_x": _init(generator, (d_model, di), **kw),
        "w_B": _init(generator, (d_model, state), **kw),
        "w_C": _init(generator, (d_model, state), **kw),
        "w_dt": _init(generator, (d_model, nh), **kw),
        "out_proj": _init(generator, (di, d_model), **kw),
        "conv_x": _init(generator, (4, di), scale=0.5, **kw),
        "conv_B": _init(generator, (4, state), scale=0.5, **kw),
        "conv_C": _init(generator, (4, state), scale=0.5, **kw),
        "A_log": torch.zeros((nh,), **f32),
        "D": torch.ones((nh,), **f32),
        "dt_bias": torch.zeros((nh,), **f32),
        "norm_w": torch.zeros((di,), **kw),
    }


def _state_cols(w: torch.Tensor) -> torch.Tensor:
    """``w_B`` / ``w_C`` [d, N] under a pinned mesh whose model axis
    splits the weights: its N columns over model where it divides them,
    so the projection's output comes split and no model rank repeats
    it."""
    if w.shape[1] % layers._mesh_size("model") == 0:
        return layers._pin(w, (None, "model"), "state_cols")
    return w


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                   state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv, width K.  x: [B,S,C]; w: [K,C].
    state: [B,K-1,C] trailing context.  Returns (y, new_state)."""
    kk = w.shape[0]
    # zero rows as zeros_like of x's own rows: placed as x under the
    # GSPMD pins (F.pad's DTensor rule in torch 2.11 drops a mesh dim)
    pad = ([torch.zeros_like(x[:, :1])] * (kk - 1) if state is None
           else [state.to(x.dtype)])
    xp = torch.cat(pad + [x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
            for i in range(kk))
    return _silu(y), xp[:, -(kk - 1):, :]


def mamba2_block(params: Dict, x: torch.Tensor, *, expand: int, state: int,
                 head_dim: int, chunk: int,
                 ssm_state: Optional[Dict] = None,
                 decode: bool = False) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: [B,S,d].  In decode mode S==1 and ``ssm_state`` carries
    {"conv_x","conv_B","conv_C" (trailing contexts), "ssd": [B,H,N,P]};
    its "ssd" is updated in place (:func:`linear_recurrence_step`)."""
    b, s, d = x.shape
    di = expand * d
    nh = di // head_dim
    w_B, w_C = params["w_B"], params["w_C"]
    if layers._tp():
        # the in-projections split as XLA splits them: the tokens whole
        # over model, each weight's output over model (``w_B`` / ``w_C``,
        # replicated by the specs, cut to their blocks: no wire)
        x = layers.replicate_model(x)
        w_B, w_C = _state_cols(w_B), _state_cols(w_C)
    mm = layers._dense_mm
    z = mm(x, params["w_z"])
    xb = mm(x, params["w_x"])
    B = mm(x, w_B)
    C = mm(x, w_C)
    dt = mm(x, params["w_dt"])

    st = ssm_state or {}
    xb, ncx = _causal_conv1d(xb, params["conv_x"], st.get("conv_x"))
    B, ncb = _causal_conv1d(B, params["conv_B"], st.get("conv_B"))
    C, ncc = _causal_conv1d(C, params["conv_C"], st.get("conv_C"))

    dt = F.softplus(dt.float() + params["dt_bias"])              # [B,S,H]
    A = -torch.exp(params["A_log"])                              # [H]
    lf = dt * A                                                  # log forget
    li = torch.log(dt + 1e-9)                                    # log input

    v = layers.split_heads(xb, nh, head_dim)
    # B and C are shared by every head: broadcast views, never copies
    # (whole over model first: the recurrence splits the heads)
    B, C = layers.tp_replicate(B), layers.tp_replicate(C)
    qh = C[:, :, None, :].expand(b, s, nh, state)
    kh = B[:, :, None, :].expand(b, s, nh, state)

    if decode:
        y, S = linear_recurrence_step(
            qh[:, 0], kh[:, 0], v[:, 0], lf[:, 0], li[:, 0], st["ssd"])
        y = y[:, None]
    else:
        y, S = chunked_linear_recurrence(qh, kh, v, lf, li, chunk=chunk,
                                         state0=st.get("ssd"))
    y = (y + v * params["D"][None, None, :, None]).to(x.dtype)
    y = layers.merge_heads(y)
    out = mm(_gated_rmsnorm(y, z, params["norm_w"]), params["out_proj"])
    new_state = ({"conv_x": ncx, "conv_B": ncb, "conv_C": ncc, "ssd": S}
                 if (decode or ssm_state is not None) else None)
    return out, new_state


# ---------------------------------------------------------------- mLSTM ---

def init_mlstm(generator, d_model: int, *, expand: int, n_heads: int,
               dtype=torch.bfloat16, device=None) -> Dict:
    di = expand * d_model
    kw = dict(dtype=dtype, device=device)
    return {
        "w_x": _init(generator, (d_model, di), **kw),
        "w_z": _init(generator, (d_model, di), **kw),
        "wq": _init(generator, (di, di), **kw),
        "wk": _init(generator, (di, di), **kw),
        "wv": _init(generator, (di, di), **kw),
        "gates": _init(generator, (di, 2 * n_heads), scale=0.02,
                       dtype=torch.float32, device=device),
        "out_proj": _init(generator, (di, d_model), **kw),
        "norm_w": torch.zeros((di,), **kw),
    }


def mlstm_block(params: Dict, x: torch.Tensor, *, expand: int, n_heads: int,
                chunk: int, ssm_state: Optional[Dict] = None,
                decode: bool = False) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: [B,S,d]; state {"ssd": [B,H,hd,hd+1]} (updated in place in
    decode mode)."""
    di = expand * x.shape[-1]
    hd = di // n_heads
    mm = layers._dense_mm
    xi = mm(x, params["w_x"])
    z = mm(x, params["w_z"])
    q = layers.split_heads(mm(xi, params["wq"]), n_heads, hd)
    k = layers.split_heads(mm(xi, params["wk"]), n_heads, hd) * hd ** -0.5
    v = layers.split_heads(mm(xi, params["wv"]), n_heads, hd)
    gates = mm(xi.float(), params["gates"])                        # [B,S,2H]
    lf = _log_sigmoid(gates[..., :n_heads])                        # forget
    li = _log_sigmoid(gates[..., n_heads:])                        # input

    # normalizer trick: append a ones column to v
    v_ext = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    st = ssm_state or {}
    if decode:
        y_ext, S = linear_recurrence_step(q[:, 0], k[:, 0], v_ext[:, 0],
                                          lf[:, 0], li[:, 0], st["ssd"])
        y_ext = y_ext[:, None]
    else:
        y_ext, S = chunked_linear_recurrence(q, k, v_ext, lf, li,
                                             chunk=chunk,
                                             state0=st.get("ssd"))
    y, nrm = y_ext[..., :hd], y_ext[..., hd:]
    y = y / torch.clamp(torch.abs(nrm), min=1.0)
    y = layers.merge_heads(y)
    out = mm(_gated_rmsnorm(y, z, params["norm_w"]), params["out_proj"])
    new_state = ({"ssd": S} if (decode or ssm_state is not None) else None)
    return out, new_state


# ---------------------------------------------------------------- sLSTM ---

def _slstm_gates(gates, c, n):
    """Pointwise sLSTM cell given pre-activations.  gates: [B,H,4*hd]."""
    zi, ii, fi, oi = torch.chunk(gates, 4, dim=-1)
    zt = torch.tanh(zi)
    it = torch.exp(torch.clamp(ii, max=10.0))
    ft = torch.sigmoid(fi)
    ot = torch.sigmoid(oi)
    c2 = ft * c + it * zt
    n2 = ft * n + it
    h2 = ot * c2 / torch.clamp(torch.abs(n2), min=1.0)
    return c2, n2, h2


def _slstm_loop(pre, r, bias, c, n, h):
    """The loop over time: the states after every step, (cs, ns, hs) each
    [S,B,H,hd]."""
    cs, ns, hs = [], [], []
    for t in range(pre.shape[1]):
        gates = pre[:, t] + torch.einsum("bhd,hdk->bhk", h, r) + bias
        c, n, h = _slstm_gates(gates, c, n)
        cs.append(c)
        ns.append(n)
        hs.append(h)
    return torch.stack(cs), torch.stack(ns), torch.stack(hs)


class _SlstmScan(torch.autograd.Function):
    """The reference's ``_slstm_scan`` custom VJP: the backward walks the
    steps in reverse, differentiating each cell on its saved states, and
    accumulates the recurrent weight's and the bias's gradients per batch
    element, summed over the batch once after the loop."""

    @staticmethod
    def forward(ctx, pre, r, bias, c0, n0, h0):
        cs, ns, hs = _slstm_loop(pre, r, bias, c0, n0, h0)
        ctx.save_for_backward(pre, r, bias, c0, n0, h0, cs, ns, hs)
        return hs.transpose(0, 1), cs[-1], ns[-1], hs[-1]

    @staticmethod
    def backward(ctx, dys, dc, dn, dh):
        pre, r, bias, c0, n0, h0, cs, ns, hs = ctx.saved_tensors
        b, s = pre.shape[:2]
        # the states entering each step, the initial carry first
        c_prev = torch.cat([c0[None], cs[:-1]])
        n_prev = torch.cat([n0[None], ns[:-1]])
        h_prev = torch.cat([h0[None], hs[:-1]])
        dr_b = torch.zeros((b,) + tuple(r.shape), device=pre.device)
        dbias_b = torch.zeros((b,) + tuple(bias.shape), device=pre.device)
        dpre = torch.empty_like(pre)
        for t in reversed(range(s)):
            dh = dh + dys[:, t]
            hp = h_prev[t]
            gates = (pre[:, t] + torch.einsum("bhd,hdk->bhk", hp, r)
                     + bias).requires_grad_(True)
            cp = c_prev[t].detach().requires_grad_(True)
            np_ = n_prev[t].detach().requires_grad_(True)
            with torch.enable_grad():
                out = _slstm_gates(gates, cp, np_)
                dgates, dc, dn = torch.autograd.grad(out, (gates, cp, np_),
                                                     (dc, dn, dh))
            dh = torch.einsum("bhk,hdk->bhd", dgates, r)
            # per-batch weight gradients: outer products, no batch sum
            dr_b += torch.einsum("bhd,bhk->bhdk", hp, dgates)
            dbias_b += dgates
            dpre[:, t] = dgates
        return dpre, dr_b.sum(0), dbias_b.sum(0), dc, dn, dh


def _slstm_scan(pre, r, bias, carry0):
    """The reference's ``_slstm_scan``: pre: [B,S,H,4hd] f32; r:
    [H,hd,4hd] f32; bias: [H,4hd] f32; carry0: (c,n,h) each [B,H,hd] f32,
    or ``None`` for zeros.  Returns (hs [B,S,H,hd], carry).
    Differentiable through :class:`_SlstmScan` when an input needs a
    gradient.  Under a pinned mesh (:func:`_pinned_recurrence`) it runs
    on each rank's blocks, ``r`` and ``bias`` whole on every rank."""
    b, s, nh, hd4 = pre.shape

    def local(pre_l, r_l, bias_l, *carry):
        if not carry:
            zeros = torch.zeros((pre_l.shape[0], nh, hd4 // 4),
                                dtype=torch.float32, device=pre_l.device)
            carry = (zeros, zeros, zeros)
        ins = (pre_l, r_l, bias_l) + tuple(carry)
        if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
            return _SlstmScan.apply(*ins)
        cs, ns, hs = _slstm_loop(*ins)
        return hs.transpose(0, 1), cs[-1], ns[-1], hs[-1]

    ins = (pre, r, bias) + (() if carry0 is None else tuple(carry0))
    if layers._ATTN_MESH["mesh"] is not None:
        hs, c, n, h = _pinned_recurrence(
            local, ins, [(b, s, nh, hd4 // 4)] + [(b, nh, hd4 // 4)] * 3,
            weights=2)
    else:
        hs, c, n, h = local(*ins)
    return hs, (c, n, h)


def _recur(h, r):
    """The sLSTM's recurrent product of a decode step, h [B,H,hd] by r
    [H,hd,4hd]: under a pinned mesh on each rank's blocks, as the scan's
    (:func:`_pinned_recurrence`, ``r`` whole on every rank)."""
    def local(hl, rl):
        return torch.einsum("bhd,hdk->bhk", hl, rl)

    if layers._ATTN_MESH["mesh"] is None:
        return local(h, r)
    return _pinned_recurrence(local, (h, r),
                              [tuple(h.shape[:2]) + (r.shape[-1],)],
                              weights=1)


def init_slstm(generator, d_model: int, *, n_heads: int,
               dtype=torch.bfloat16, device=None) -> Dict:
    hd = d_model // n_heads
    kw = dict(dtype=dtype, device=device)
    return {
        "w_in": _init(generator, (d_model, 4 * d_model), **kw),
        "r": _init(generator, (n_heads, hd, 4 * hd), **kw),
        "bias": torch.zeros((4 * d_model,), dtype=torch.float32,
                            device=device),
        "out_proj": _init(generator, (d_model, d_model), **kw),
    }


def slstm_block(params: Dict, x: torch.Tensor, *, n_heads: int,
                ssm_state: Optional[Dict] = None,
                decode: bool = False) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Sequential sLSTM with per-head block-diagonal recurrence.

    state: {"c","n","h"} each [B, H, hd] (read; the new state is new
    tensors)."""
    b, _, d = x.shape
    hd = d // n_heads
    mm = layers._dense_mm
    pre = layers.split_heads(mm(x, params["w_in"]).float(), n_heads,
                             4 * hd)
    r = params["r"].float()
    bias = params["bias"].reshape(n_heads, 4 * hd)

    carry = (None if ssm_state is None
             else (ssm_state["c"], ssm_state["n"], ssm_state["h"]))

    if decode:
        if carry is None:
            zeros = torch.zeros((b, n_heads, hd), dtype=torch.float32,
                                device=x.device)
            carry = (zeros, zeros, zeros)
        c, n, h = carry
        gates = pre[:, 0] + _recur(h, r) + bias
        carry = _slstm_gates(gates, c, n)
        ys = carry[2][:, None]
    else:
        ys, carry = _slstm_scan(pre, r, bias, carry)
    y = layers.merge_heads(ys).to(x.dtype)
    out = mm(y, params["out_proj"])
    c, n, h = carry
    new_state = ({"c": c, "n": n, "h": h}
                 if (decode or ssm_state is not None) else None)
    return out, new_state

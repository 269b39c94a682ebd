"""Mixture-of-Experts layer: top-k router + grouped capacity dispatch --
the port of ``repro/models/moe.py``.

Dispatch uses the grouped one-hot formulation (Switch/GShard style):
tokens are split into groups of ``group_size``; each group builds a
``[t, E, C_g]`` dispatch tensor with per-group capacity
``C_g = max(k, ceil(cf * t * k / E))``.  Tokens overflowing an expert's
capacity are dropped (their combine weight is 0), as in GShard.

With ``dist_mesh`` (a ``(Pm, Pn, Pc)`` serving mesh) the expert
contractions run through :func:`repro_torch.dist.lm.expert_ffn_distributed`
-- experts over the contraction (c) ring, the expert ff dim over n, each
per-expert product through ``kernels.ops.local_matmul``.  Otherwise,
under ``train.step.place_gspmd``'s mesh, the dispatch and combine tensors
are pinned as the reference's GSPMD pin places them (the expert dim over
the model axis, where the expert weights' is by ``parallel.sharding``,
the groups over the data axes) and every product runs on each rank's
blocks (:func:`_placed_experts`); without a mesh they run as they are.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (_ATTN_MESH, _b_spec, _dp_size,
                                       _init, _mesh_size, _pin,
                                       replicate_model)


def _dispatch_spec(shape) -> tuple:
    """The pin of a [g, t, E, C] dispatch tensor: groups over the data
    axes, E over model where it divides and the model axis carries no
    batch."""
    m = _mesh_size("model")
    e_spec = "model" if (m > 1 and shape[2] % m == 0
                         and "model" not in _ATTN_MESH["dp"]) else None
    return (_b_spec(shape[0]), None, e_spec, None)


def _token_spec(g: int, gsz: int) -> tuple:
    """The pin of the [g, t, d] token groups that the router, top-k and
    the one-hots read: the groups over the data axes where they divide,
    the tokens over every other axis that divides them (the data axes
    first when the groups are whole, then model, when it carries no
    batch), as XLA splits the router's tokens."""
    dp, m = _ATTN_MESH["dp"], _mesh_size("model")
    g_spec = _b_spec(g)
    free = [] if g_spec is not None else list(dp)
    if m > 1 and "model" not in dp:
        free.append("model")
    while free and gsz % math.prod(_mesh_size(a) for a in free):
        free.pop()
    t_spec = (None if not free else free[0] if len(free) == 1
              else tuple(free))
    return (g_spec, t_spec, None)


def _combine_spec(shape) -> tuple:
    """The pin of the [g, t, E, C] combine weights at the combine: the
    dispatch's (:func:`_dispatch_spec`), and the tokens over the data
    axes when the groups are not (a decode step's one group), so no rank
    sums the combine of another's tokens."""
    spec = _dispatch_spec(shape)
    dp = _ATTN_MESH["dp"]
    if spec[0] is None and dp and "model" not in dp \
            and shape[1] % _dp_size() == 0:
        spec = (None, dp if len(dp) > 1 else dp[0]) + spec[2:]
    return spec


def _router(xs: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """The router's logits [g, t, E] of the tokens ``xs`` [g, t, d] (f32):
    under a pinned mesh on each rank's tokens (``collectives.local_map``),
    ``router`` whole on every rank and its gradient a pending sum over
    the axes that split the tokens; DTensor's own product flattens the
    groups and their tokens into one, which torch 2.11 refuses while
    both are split."""
    if _ATTN_MESH["mesh"] is None:
        return torch.einsum("gtd,de->gte", xs, router)
    from repro_torch.dist.collectives import _spec_axes, local_map, spec_of
    mesh = _ATTN_MESH["mesh"]
    spec = spec_of(xs)
    router = _pin(router, (None, None), "router")
    axes = tuple(a for entry in spec for a in _spec_axes(entry))
    return local_map(lambda xl, rl: torch.einsum("gtd,de->gte", xl, rl),
                     mesh, (spec, (None, None)), spec,
                     grad_sum_axes=[(), axes])(xs, router)


def _shard_dispatch(x: torch.Tensor) -> torch.Tensor:
    """Constrain [g, t, E, C] dispatch tensors to E-over-model (and groups
    over the data axes), the reference's pin; the identity without a
    mesh."""
    if _ATTN_MESH["mesh"] is None:
        return x
    return _pin(x, _dispatch_spec(x.shape), "dispatch")


def _dispatch(disp, xg):
    """Each expert's capacity slots [g, E, C, d] of the tokens ``xg``
    [g, t, d] by the one-hots ``disp`` [g, t, E, C]: a product over the
    flattened (E, C)."""
    g, t, e, c = disp.shape
    return torch.bmm(disp.reshape(g, t, e * c).transpose(1, 2),
                     xg).reshape(g, e, c, xg.shape[-1])


def _ffn_in(xe, w):
    return torch.einsum("gecd,edf->gecf", xe, w)


def _act(hgate, hup):
    return (F.silu(hgate.float()) * hup.float()).to(hgate.dtype)


def _ffn_out(hact, w):
    return torch.einsum("gecf,efd->gecd", hact, w)


def _combine(comb, ye):
    """The tokens [g, t, d] (f32) of the experts' outputs ``ye`` [g, E, C,
    d] by the combine weights ``comb`` [g, t, E, C]: a product over the
    flattened (E, C)."""
    g, e, c, d = ye.shape
    return torch.bmm(comb.reshape(g, comb.shape[1], e * c),
                     ye.float().reshape(g, e * c, d))


def _experts(disp, xg, comb, w_gate, w_up, w_down):
    """The dispatch, the experts' SwiGLU FFN and the combine."""
    xe = _dispatch(disp, xg)
    return _combine(comb, _ffn_out(_act(_ffn_in(xe, w_gate),
                                        _ffn_in(xe, w_up)), w_down))


def _placed_experts(disp, xg, comb, params):
    """:func:`_experts` with each product on each rank's (g, E, C) blocks
    (``collectives.local_map``), as the router runs: the one-hots pinned E
    over model and the groups over the data axes where they divide
    (:func:`_dispatch_spec`; the combine's tokens over the data axes when
    the groups are whole, :func:`_combine_spec`), the tokens ``xg`` as
    they come (groups over data, whole over model).  An expert weight's
    FSDP split (its input features over a data axis) is gathered where
    the groups take that axis; else it stays, and the products split
    their features there (pending sums settled before the activation and
    before the combine), as for a decode step's one group.  The
    combine's output is a pending sum over the axes that split E; each
    weight's gradient one over the axes that split the groups."""
    from repro_torch.dist import collectives as C
    from repro_torch.models.layers import _entry
    mesh = _ATTN_MESH["mesh"]
    dspec = _dispatch_spec(disp.shape)
    cspec = _combine_spec(comb.shape)
    disp = _shard_dispatch(disp)
    comb = _pin(comb, cspec, "dispatch")
    g_spec, e_spec = dspec[0], dspec[2]
    e_axes, g_axes = C._spec_axes(e_spec), C._spec_axes(g_spec)
    t_axes = C._spec_axes(cspec[1])
    f_axes = tuple(a for a in C.shard_axes(params["w_gate"], 1)
                   if a not in g_axes)
    wspec = (e_spec, _entry(f_axes), None)
    w_gate, w_up, w_down = (C.constrain(params[k], mesh, wspec,
                                        tag="experts")
                            for k in ("w_gate", "w_up", "w_down"))
    split = (g_spec, e_spec, None, _entry(f_axes))    # [g,E,C,d or f]
    whole = (g_spec, e_spec, None, None)
    xs = (g_spec, None, _entry(f_axes))
    xe = C.local_map(_dispatch, mesh, (dspec, xs), split,
                     grad_sum_axes=[(), e_axes])(
        disp, C.constrain(xg, mesh, xs, tag="experts"))

    def product(fn, a, w):
        return C.settle(C.local_map(fn, mesh, (split, wspec), whole,
                                    grad_sum_axes=[(), g_axes],
                                    out_sum_axes=f_axes)(a, w),
                        tag="experts")

    hact = _act(product(_ffn_in, xe, w_gate), product(_ffn_in, xe, w_up))
    ye = product(_ffn_out, C.constrain(hact, mesh, split, tag="experts"),
                 w_down)
    return C.local_map(_combine, mesh, (cspec, whole),
                       (cspec[0], cspec[1], None),
                       grad_sum_axes=[(), t_axes],
                       out_sum_axes=e_axes)(comb, ye)


def init_moe(generator, d_model: int, d_ff: int, n_experts: int,
             dtype=torch.float32, device=None) -> Dict:
    kw = dict(dtype=dtype, device=device)
    return {
        "router": _init(generator, (d_model, n_experts), scale=0.02,
                        dtype=torch.float32, device=device),
        "w_gate": _init(generator, (n_experts, d_model, d_ff), **kw),
        "w_up": _init(generator, (n_experts, d_model, d_ff), **kw),
        "w_down": _init(generator, (n_experts, d_ff, d_model), **kw),
    }


def moe_group_size(n_tok: int, group_size: int) -> int:
    """The token group size ``moe_layer`` uses for ``n_tok`` tokens: the
    largest ``group_size / 2^i`` that divides ``n_tok``."""
    gsz = min(group_size, n_tok)
    while n_tok % gsz != 0:
        gsz //= 2
    return gsz


def moe_capacity(gsz: int, top_k: int, n_experts: int,
                 capacity_factor: float) -> int:
    """Per-group expert capacity."""
    return max(top_k, int(math.ceil(capacity_factor * gsz * top_k
                                    / n_experts)))


def moe_layer(params: Dict, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, group_size: int = 4096,
              dist_mesh=None, dist_schedule: str = "allgather"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (out [B, S, d], aux_loss scalar).

    With ``dist_mesh`` the expert contractions run through
    ``expert_ffn_distributed`` when the shapes divide the grid; otherwise
    the dense einsum path below runs unchanged.  ``dist_schedule`` is
    accepted for the reference's signature (the expert FFN has one
    schedule: a single all-reduce)."""
    b, s, d = x.shape
    e = params["router"].shape[1]
    n_tok = b * s
    gsz = moe_group_size(n_tok, group_size)
    g = n_tok // gsz
    from repro_torch.dist import collectives as C
    pinned = _ATTN_MESH["mesh"] is not None
    # the view below flattens the batch and the sequence: a placed x
    # keeps only the batch's split (the sequence made whole, as the
    # dispatch needs each group's tokens whole anyway)
    xg_in = C.flattenable(x, tag="moe_tokens").reshape(g, gsz, d)
    # the dispatch reads the groups over the data axes where they divide,
    # else whole (a decode step's one group): DTensor would otherwise
    # carry the tokens' batch sharding into the capacity dim, unevenly,
    # and no view of it flattens.  The router, top-k and the one-hots run
    # on each rank's share of the tokens (:func:`_token_spec`), as XLA
    # splits them.  The output goes back to the groups' first placement
    # before the view back to [B, S, d].
    xg = replicate_model(xg_in)
    xs = (_pin(xg_in, _token_spec(g, gsz), "moe_tokens") if pinned
          else xg_in)

    logits = _router(xs.float(), params["router"])
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)       # [g,t,k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # Switch-style load-balance aux loss (over all tokens)
    me = probs.mean(dim=(0, 1))                                  # [E]
    fe = F.one_hot(gate_idx[..., 0], e).float().mean(dim=(0, 1))
    aux = e * torch.sum(me * fe)

    capacity = moe_capacity(gsz, top_k, e, capacity_factor)

    # the slots count the group's tokens in order: whole along them
    gate_vals, gate_idx = replicate_model(gate_vals), replicate_model(
        gate_idx)
    onehot = F.one_hot(gate_idx, e)                              # [g,t,k,E]
    flat = onehot.reshape(g, gsz * top_k, e)
    pos = torch.cumsum(flat, dim=1) * flat - 1                   # [g,t*k,E]
    pos = pos.reshape(g, gsz, top_k, e)
    keep = (pos >= 0) & (pos < capacity)
    posc = torch.where(keep, pos, 0)

    disp = torch.zeros((g, gsz, e, capacity), dtype=x.dtype, device=x.device)
    comb = torch.zeros((g, gsz, e, capacity), dtype=torch.float32,
                       device=x.device)
    for slot in range(top_k):                                    # small k
        sel = (F.one_hot(posc[:, :, slot], capacity).float()
               * (keep[:, :, slot].float()
                  * onehot[:, :, slot].float())[..., None])
        disp = disp + sel.to(x.dtype)
        comb = comb + sel * gate_vals[:, :, slot, None, None]

    if dist_mesh is not None:
        from repro_torch.dist import lm as dist_lm
        if dist_lm.moe_ffn_grid_divides(e, params["w_gate"].shape[2],
                                        dist_lm.mesh_grid(dist_mesh)):
            out = dist_lm.expert_ffn_distributed(
                xg, disp, comb, params["w_gate"], params["w_up"],
                params["w_down"], dist_mesh)
            return out.reshape(b, s, d).to(x.dtype), aux

    if not pinned:
        out = _experts(disp, xg, comb, params["w_gate"], params["w_up"],
                       params["w_down"])
    else:
        out = C.constrain_like(_placed_experts(disp, xg, comb, params),
                               xg_in, tag="dispatch")
    # the output's gradient comes back split like the residual: its view
    # back to the groups flattens the batch and the sequence
    return C.grad_flattenable(out.reshape(b, s, d).to(x.dtype),
                              tag="moe_tokens"), aux

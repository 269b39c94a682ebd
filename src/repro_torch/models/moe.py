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
per-expert product through ``kernels.ops.local_matmul``.  Otherwise the
dispatch and combine tensors are pinned by :func:`_shard_dispatch`, the
reference's GSPMD pin: under ``train.step.place_gspmd``'s mesh the expert
dim goes over the model axis (where the expert weights' is, by
``parallel.sharding``) and the groups over the data axes; without a mesh
it is the identity.
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
    over the data axes).  The router logits are replicated over the model
    axis, so each rank builds its experts' slice locally."""
    if _ATTN_MESH["mesh"] is None:
        return x
    from repro_torch.dist.collectives import constrain
    return constrain(x, _ATTN_MESH["mesh"], _dispatch_spec(x.shape),
                     tag="dispatch")


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

    disp = _shard_dispatch(disp)
    comb = _shard_dispatch(comb)

    # the dispatch and combine einsums as products over the flattened
    # (E, C), E leading: torch 2.11's DTensor flattens a split E only
    # there (``einsum`` puts C first).  The gradient pins pass plain
    # tensors as they are.
    xe = torch.bmm(disp.reshape(g, gsz, e * capacity).transpose(1, 2),
                   xg).reshape(g, e, capacity, d)                # [g,E,C,d]
    # each einsum's backward views the gradient of its output
    hgate = C.grad_contiguous(torch.einsum("gecd,edf->gecf", xe,
                                           params["w_gate"]))
    hup = C.grad_contiguous(torch.einsum("gecd,edf->gecf", xe,
                                         params["w_up"]))
    hact = (F.silu(hgate.float()) * hup.float()).to(x.dtype)
    ye = torch.einsum("gecf,efd->gecd", hact, params["w_down"])
    # the combine's backward would leave C split beside E
    ye = C.grad_placed_as(ye.float().reshape(g, e * capacity, d),
                          tag="dispatch")
    if pinned:
        comb = _pin(comb, _combine_spec(comb.shape), "dispatch")
    out = torch.bmm(comb.reshape(g, gsz, e * capacity), ye)      # [g,t,d]
    if pinned:
        out = C.constrain_like(out, xg_in, tag="dispatch")
    # the output's gradient comes back split like the residual: its view
    # back to the groups flattens the batch and the sequence
    return C.grad_flattenable(out.reshape(b, s, d).to(x.dtype),
                              tag="moe_tokens"), aux

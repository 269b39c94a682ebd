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
per-expert product through ``kernels.ops.local_matmul``.  The
reference's ``_shard_dispatch`` is a GSPMD pin of the dispatch tensors;
the port has no GSPMD mode, so it is the identity and is left out.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _init


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
    xg = x.reshape(g, gsz, d)

    logits = torch.einsum("gtd,de->gte", xg.float(), params["router"])
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)       # [g,t,k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # Switch-style load-balance aux loss (over all tokens)
    me = probs.mean(dim=(0, 1))                                  # [E]
    fe = F.one_hot(gate_idx[..., 0], e).float().mean(dim=(0, 1))
    aux = e * torch.sum(me * fe)

    capacity = moe_capacity(gsz, top_k, e, capacity_factor)

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

    xe = torch.einsum("gtd,gtec->gecd", xg, disp)                # [g,E,C,d]
    hgate = torch.einsum("gecd,edf->gecf", xe, params["w_gate"])
    hup = torch.einsum("gecd,edf->gecf", xe, params["w_up"])
    hact = (F.silu(hgate.float()) * hup.float()).to(x.dtype)
    ye = torch.einsum("gecf,efd->gecd", hact, params["w_down"])
    out = torch.einsum("gecd,gtec->gtd", ye.float(), comb)
    return out.reshape(b, s, d).to(x.dtype), aux

"""LM serving on the ``(Pm, Pn, Pc)`` matmul grid -- the port of
``repro/dist/lm.py``: the paper's 2D-SUMMA / 2.5D / 3D family routed
under transformer inference.

A decoder-only transformer step is a chain of matmuls: the QKV/O
projections, the (possibly gated) MLP, and the vocabulary head.  Each one
is the degenerate 1x1 CNN of the paper, so each one runs on the explicit
``(Pm, Pn, Pc)`` grid through
:func:`repro_torch.dist.matmul.matmul_distributed`
-- token rows over m, output features over n, the d_model contraction
sub-sharded over c (2.5D replication when ``Pc > 1``) -- and its per-step
products through ``kernels.ops.local_matmul``.

:func:`dist_projection` is the routing shim ``models/lm.py`` calls when a
``dist_mesh=`` is passed.  It flattens ``[..., C] @ [C, N]`` to the 2D
matmul view, checks the runtime sub-shard divisibility constraints, and
falls back to the dense product for shapes the grid cannot divide.  The
reference hands ``shard_map`` logical arrays; the port's
``matmul_distributed`` is per-rank code on shards, so the shim cuts this
rank's ``X_SPEC`` / ``W_SPEC`` blocks out of the replicated activation and
weight (``collectives.shard``: slices, no wire) and gathers the
``OUT_SPEC`` output back onto every rank (``collectives.unshard``, tag
``"serve_glue"``).  The weight shard is cut on every call (on one rank
that is the weight itself, no copy); every rank holds the replicated
weights, so the ``weights_sharded`` term of :func:`lm_serve_mem_elems`
(each rank keeping only its shard) is the memory a serving deployment
that cuts the shards once would hold, not what this engine holds.  Each
routed projection's collectives are recorded under its parameter's name
(``collectives.note_scope``: ``"wq:gather_axis"``, ``"wq:serve_glue"``),
so the recorded wire can be held against :func:`lm_serve_comm_elems` term
by term, with the glue apart: the accounting counts the routed matmuls
and the MoE combine only, the reference's "tight lower bound on the whole
step" for the same reason.

**MoE expert contractions.**  :func:`expert_ffn_distributed` runs the
grouped expert FFN (``models/moe.py`` dispatch -> per-expert gate/up/down
-> combine) with the *expert dimension on the contraction ring*: each
c-rank owns ``E/Pc`` experts, the expert ff dim shards over n, and the
only communication is one all-reduce of the combined ``[g, t, d]`` output
over the ``(n, c)`` plane (tag ``"moe_combine"``, scope ``"moe_ffn"``).

Every rank must pick the same greedy token, or the ranks' engines
diverge and the next collective hangs.  Every rank computes the
replicated glue on the same inputs, each output block of a projection
comes from one all-reduce (identical on its ranks) or from one rank, and
the gathers copy, so the logits are bitwise equal on every rank.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.dist import collectives
from repro_torch.dist.collectives import (SCHEDULES, note_scope, psum, shard,
                                          unshard)
from repro_torch.dist.matmul import (AXES, OUT_SPEC, W_SPEC, X_SPEC,
                                     matmul_comm_elems, matmul_distributed,
                                     matmul_grid_divides, matmul_mem_elems)
from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import gelu
from repro_torch.models.moe import moe_capacity, moe_group_size

GLUE_TAG = "serve_glue"
DISP_SPEC = (None, None, "c", None)          # [g, t, E, C]: experts over c
W_UP_SPEC = ("c", None, "n")                 # [E, d, f]
W_DOWN_SPEC = ("c", "n", None)               # [E, f, d]


def mesh_grid(mesh: DeviceMesh) -> Tuple[int, int, int]:
    """The ``(Pm, Pn, Pc)`` tuple of a serving mesh."""
    names = tuple(mesh.mesh_dim_names or ())
    missing = [a for a in AXES if a not in names]
    if missing:
        raise ValueError(f"mesh lacks axes {missing}; use make_matmul_mesh")
    return collectives.mesh_grid(mesh, AXES)


# ------------------------------------------------------------ projections --

def dist_projection(x: torch.Tensor, w: torch.Tensor, mesh: DeviceMesh, *,
                    schedule: str = "allgather",
                    name: str = "") -> torch.Tensor:
    """``x[..., C] @ w[C, N]`` through ``matmul_distributed`` on ``mesh``,
    replicated in and out (per rank, see the module docstring).

    Leading dims of ``x`` are flattened into the matmul row (m) dim.
    Shapes that violate the grid's sub-shard divisibility constraints run
    the dense product instead.  ``name`` scopes the recorded
    collectives."""
    C, N = w.shape
    lead = x.shape[:-1]
    M = 1
    for s in lead:
        M *= s
    if not matmul_grid_divides(M, C, N, mesh_grid(mesh)):
        return x @ w
    with note_scope(name):
        xl = shard(x.reshape(M, C), mesh, X_SPEC)
        wl = shard(w, mesh, W_SPEC)
        out = matmul_distributed(xl, wl, mesh, schedule=schedule)
        out = unshard(out, mesh, OUT_SPEC, tag=GLUE_TAG)
    return out.reshape(*lead, N)


def projection_routed(M: int, C: int, N: int, grid) -> bool:
    """True when ``dist_projection`` routes this shape through the grid
    (rather than falling back to the dense product)."""
    return matmul_grid_divides(M, C, N, grid)


# ------------------------------------------------------------- MoE expert --

def moe_ffn_grid_divides(n_experts: int, d_ff: int, grid) -> bool:
    """True when the expert FFN shards on ``grid``: experts over the
    c-ring, the expert ff dim over n."""
    pm, pn, pc = grid
    return n_experts % pc == 0 and d_ff % pn == 0


def _expert_ffn_local(xg, disp, comb, w_gate, w_up, w_down, mesh, *,
                      act: str):
    """Per-rank body: dispatch to the local experts, contract, combine.

    ``disp``/``comb`` hold this c-rank's experts and the weights this
    n-rank's ff columns, so dispatch and the nonlinearity are entirely
    local; the combined output is a partial sum over (n, c) finished by
    one all-reduce."""
    g, t, d = xg.shape
    el, cap = disp.shape[2], disp.shape[3]
    gate_fn = F.silu if act == "swiglu" else gelu
    # dispatch: select this rank's experts' token slots (no comm)
    xe = torch.einsum("gtd,gtec->gecd", xg, disp.to(xg.dtype))
    outs = []
    for e in range(el):
        xr = xe[:, e].reshape(g * cap, d)
        hup = kops.local_matmul(xr, w_up[e])
        if act in ("swiglu", "geglu"):
            hgate = kops.local_matmul(xr, w_gate[e])
            h = (gate_fn(hgate.float()) * hup.float()).to(xg.dtype)
        else:
            h = gelu(hup.float()).to(xg.dtype)
        outs.append(kops.local_matmul(h, w_down[e]))
    ye = torch.stack(outs).reshape(el, g, cap, d).permute(1, 0, 2, 3)
    # combine is linear in ye: contract the local experts/slots first,
    # then finish the partial sums over the ff (n) and expert (c) shards
    # with a single all-reduce of the small [g, t, d] output
    out = torch.einsum("gecd,gtec->gtd", ye.float(), comb)
    return psum(out, mesh, ("n", "c"), tag="moe_combine").to(xg.dtype)


def expert_ffn_distributed(xg, disp, comb, w_gate, w_up, w_down,
                           mesh: DeviceMesh, *, act: str = "swiglu"):
    """Grouped expert FFN with the expert dim on the contraction ring.

    ``xg: [g, t, d]`` grouped tokens, ``disp``/``comb``: ``[g, t, E, C]``
    dispatch/combine tensors, ``w_gate``/``w_up``: ``[E, d, f]``,
    ``w_down``: ``[E, f, d]``, all replicated.  Experts shard over the c
    axis, the expert ff dim over n; the m axis replicates.  Requires
    :func:`moe_ffn_grid_divides`."""
    grid = mesh_grid(mesh)
    e, f = w_gate.shape[0], w_gate.shape[2]
    if not moe_ffn_grid_divides(e, f, grid):
        raise ValueError(f"experts {e} % Pc {grid[2]} or d_ff {f} % Pn "
                         f"{grid[1]}")
    with note_scope("moe_ffn"):
        return _expert_ffn_local(
            xg, shard(disp, mesh, DISP_SPEC), shard(comb, mesh, DISP_SPEC),
            shard(w_gate, mesh, W_UP_SPEC), shard(w_up, mesh, W_UP_SPEC),
            shard(w_down, mesh, W_DOWN_SPEC), mesh, act=act)


def moe_ffn_comm_elems(g: int, t: int, d: int, grid) -> float:
    """Per-device wire (elements) of one ``expert_ffn_distributed`` call:
    a single all-reduce of the combined ``[g, t, d]`` output over the
    ``(n, c)`` plane (ring model ``2 V (P-1)/P``)."""
    pm, pn, pc = grid
    plane = pn * pc
    if plane == 1:
        return 0.0
    return 2.0 * g * t * d * (plane - 1) / plane


# ---------------------------------------------------------- serve account --

def lm_decode_matmuls(cfg: ModelConfig, slots: int
                      ) -> List[Tuple[str, int, int, int]]:
    """The ``(name, M, C, N)`` projection shapes of one decode step
    (per layer; the vocab head is listed once as ``lm_head``)."""
    d, hd = cfg.d_model, cfg.head_dim
    shapes = [
        ("wq", slots, d, cfg.n_heads * hd),
        ("wk", slots, d, cfg.n_kv_heads * hd),
        ("wv", slots, d, cfg.n_kv_heads * hd),
        ("wo", slots, cfg.n_heads * hd, d),
    ]
    if not cfg.is_moe:
        if cfg.mlp_act in ("swiglu", "geglu"):
            shapes.append(("w_gate", slots, d, cfg.d_ff))
        shapes.append(("w_up", slots, d, cfg.d_ff))
        shapes.append(("w_down", slots, cfg.d_ff, d))
    shapes.append(("lm_head", slots, d, cfg.vocab))
    return shapes


def lm_step_products(cfg: ModelConfig, rows: int, decode: bool
                     ) -> List[Tuple[int, int, int]]:
    """``(M, C, N)`` of every local product one decode step (``rows`` =
    the slots) or one prefill (``rows`` = the bucket) runs on the
    ``(1,1,1)`` grid, in no particular order: the routed projections of
    every layer, the head (one row at prefill) and the MoE expert
    products at the capacity ``models/moe.py`` gives."""
    out = []
    for name, _, c, n in lm_decode_matmuls(cfg, rows):
        if name == "lm_head":
            out.append((rows if decode else 1, c, n))
        else:
            out += [(rows, c, n)] * cfg.n_layers
    if cfg.is_moe:
        gsz = moe_group_size(rows, cfg.moe_group_size)
        m = rows // gsz * moe_capacity(gsz, cfg.top_k, cfg.n_experts,
                                       cfg.capacity_factor)
        experts = cfg.n_layers * cfg.n_experts
        out += [(m, cfg.d_model, cfg.d_ff)] * (2 * experts)
        out += [(m, cfg.d_ff, cfg.d_model)] * experts
    return out


def _moe_decode_group(cfg: ModelConfig, slots: int) -> Tuple[int, int]:
    """(g, t) token grouping ``models/moe.py`` uses for a decode step."""
    gsz = moe_group_size(slots, cfg.moe_group_size)
    return slots // gsz, gsz


def lm_serve_comm_elems(cfg: ModelConfig, grid, *, slots: int,
                        schedule: str = "allgather") -> Dict:
    """Analytic per-device wire volume (elements) of ONE decode token
    step across all ``slots`` -- the per-token serving wire.

    Sums ``matmul_comm_elems`` over every grid-routed projection (dense
    fallbacks contribute 0, mirroring :func:`dist_projection`), plus the
    MoE combine all-reduce.  Equals the wire the port records for the
    routed matmuls and the combine of one decode step, term by term; the
    glue (``"serve_glue"``) is not counted.
    """
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}")
    per_layer: Dict[str, float] = {}
    head = 0.0
    for name, M, C, N in lm_decode_matmuls(cfg, slots):
        elems = (matmul_comm_elems(M, C, N, grid)["total"]
                 if matmul_grid_divides(M, C, N, grid) else 0.0)
        if name == "lm_head":
            head = elems
        else:
            per_layer[name] = elems
    if cfg.is_moe:
        g, t = _moe_decode_group(cfg, slots)
        per_layer["moe_ffn"] = (
            moe_ffn_comm_elems(g, t, cfg.d_model, grid)
            if moe_ffn_grid_divides(cfg.n_experts, cfg.d_ff, grid) else 0.0)
    layer_total = sum(per_layer.values())
    total = cfg.n_layers * layer_total + head
    return {"per_layer": per_layer, "layer_total": layer_total,
            "lm_head": head, "total": total,
            "per_slot": total / max(slots, 1)}


def kv_cache_elems(cfg: ModelConfig, slots: int, max_seq: int) -> float:
    """Global KV cache size (elements): K and V, all layers."""
    return 2.0 * cfg.n_layers * slots * max_seq * cfg.n_kv_heads \
        * cfg.head_dim


def lm_serve_mem_elems(cfg: ModelConfig, grid, *, slots: int, max_seq: int,
                       schedule: str = "allgather") -> Dict:
    """Analytic per-device peak live memory (elements) of the serving
    engine: grid-sharded weights + the KV cache sharded over m (slots
    ride the matmul row axis) + the worst projection's transient peak.

    Weights of grid-routed projections shard ``1/P``; dense-fallback
    projections, norms, the router and the embedding table replicate.
    """
    pm, pn, pc = grid
    P_tot = pm * pn * pc
    d = cfg.d_model
    w_sharded = 0.0
    w_replicated = float(cfg.vocab * d)          # embedding table (take)
    act_peak = 0.0
    for name, M, C, N in lm_decode_matmuls(cfg, slots):
        w = float(C * N)
        mult = 1 if name == "lm_head" else cfg.n_layers
        if matmul_grid_divides(M, C, N, grid):
            w_sharded += mult * w / P_tot
            act_peak = max(act_peak,
                           matmul_mem_elems(M, C, N, grid,
                                            schedule=schedule)["peak"])
        else:
            w_replicated += mult * w
            act_peak = max(act_peak, float(M * C + C * N + M * N))
    if cfg.is_moe:
        w_exp = float(cfg.n_experts * 3 * d * cfg.d_ff)
        if moe_ffn_grid_divides(cfg.n_experts, cfg.d_ff, grid):
            w_sharded += cfg.n_layers * w_exp / (pn * pc)
        else:
            w_replicated += cfg.n_layers * w_exp
        w_replicated += cfg.n_layers * float(d * cfg.n_experts)  # router
    w_replicated += (2 * cfg.n_layers + 1) * d                   # norms
    cache = kv_cache_elems(cfg, slots, max_seq) / (pm if slots % pm == 0
                                                   else 1)
    peak = w_sharded + w_replicated + cache + act_peak
    return {"weights_sharded": w_sharded, "weights_replicated": w_replicated,
            "kv_cache": cache, "act_peak": act_peak, "peak": peak}

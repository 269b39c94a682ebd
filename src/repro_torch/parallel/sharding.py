"""Sharding rules: the paper's grid synthesizer deciding per-layer tensor
parallelism -- the port of ``repro/parallel/sharding.py``.

For every weight matmul ``[.., cin, cout]`` the operator is read as a CNN
(``ConvProblem.from_matmul(tokens, cout, cin)``) and the paper's cost
model decides where the *model* mesh axis pays off best:

  model -> 'k'    shard cout   (Megatron column parallel / 2D grid k-axis)
  model -> 'c'    shard cin    (row parallel + psum -- the 2.5D/3D c-axis)
  model -> 'bhw'  replicate the weight (pure data parallel for this op)

Data axes always carry the batch.  FSDP (``cfg.fsdp``) also shards a
weight dim over the data axis.

A spec is a tuple with one entry per tensor dim: ``None``, an axis name,
or a tuple of axis names (major first) -- the convention of
``dist.collectives.shard``, equal to ``tuple(PartitionSpec)`` of the
reference.  ``dist.collectives.placements`` turns one into DTensor
placements on a ``DeviceMesh``.  Every rule takes the mesh as a
``DeviceMesh`` or as a mapping from axis name to extent, so the decisions
of a full-width mesh are computed with no process group.

Layer layout.  The reference stacks each layer kind's leaves over the
layers (``blocks/attn/wq`` is ``[L, cin, cout]``); the port keeps one dict
per layer (``params["blocks"][i]``).  A port leaf's spec is the
reference's stacked spec without its leading layer entry, its decision is
keyed by the reference's name (``blocks/attn/wq``), and its residency
budget is computed from the stacked count and divided by ``L``, as the
reference's is.

The memory figures are the device's: ``device_budget`` reads the card's
``total_memory`` (80 GB on an H100), or the host's memory for the CPU.
The residency budget is :data:`HBM_USABLE_FRACTION` of it; the fast
memory of the tile choice is the same bytes counted in bf16 elements.
"""

from __future__ import annotations

import functools
import math
import os
import re
from typing import Any, Dict, Mapping, Optional, Tuple

from repro_torch.core import cost_model
from repro_torch.core.cost_model import TileChoice
from repro_torch.core.problem import ConvProblem
from repro_torch.core.tile_optimizer import _best_tiles_given_W

#: Share of the device memory the weights' training (or serving) state
#: may take in the Eq. 11 residency budget, as the reference's.
HBM_USABLE_FRACTION = 0.6

#: The layer lists: leaves under them are stacked over layers in the
#: reference.
_STACKED = ("blocks", "mblocks", "sblocks", "enc", "dec")


def device_budget(device=None) -> Tuple[float, int]:
    """``(memory bytes, the same in bf16 elements)`` of ``device``: a
    card's ``total_memory`` (``cuda`` by default), the host's physical
    memory for the CPU."""
    import torch

    from repro_torch.device import resolve_device
    device = resolve_device(device)
    if device.type == "cuda":
        nbytes = torch.cuda.get_device_properties(device).total_memory
    else:
        nbytes = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return float(nbytes), int(nbytes) // 2


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: extent}`` of a ``DeviceMesh`` or of a mapping."""
    if isinstance(mesh, Mapping):
        return {str(a): int(n) for a, n in mesh.items()}
    return {a: int(n) for a, n in zip(mesh.mesh_dim_names, mesh.shape)}


def _op_cost(m: int, n: int, k: int, pbhw: int, pk: int, pc: int,
             M_L: float) -> float:
    """Eq. 3 cost of one matmul operator under a concrete grid."""
    prob = ConvProblem.from_matmul(m, n, k)
    if pbhw > prob.Nbhw or pk > prob.Nk or pc > prob.Nc:
        return float("inf")
    Wbhw, Wk, Wc = prob.Nbhw / pbhw, prob.Nk / pk, prob.Nc / pc
    Tbhw, Tk = _best_tiles_given_W(prob, Wbhw, Wk, M_L)
    return cost_model.cost_global_memory(
        prob, TileChoice(Wbhw=Wbhw, Wk=Wk, Wc=Wc, Tbhw=Tbhw, Tk=Tk))


@functools.lru_cache(maxsize=65536)
def _decide(tokens: int, cin: int, cout: int, data: int, model: int,
            pod: int, train: bool, budget_elems: int,
            mem_elems: Optional[int] = None) -> str:
    """Where the model axis pays off best for this matmul, per the paper's
    cost model ('k' | 'c' | 'bhw').

    Training prices the full step as THREE instances of the paper's
    operator with role-permuted grids -- fwd ([m,c]x[c,k]), dIn
    ([m,k]x[k,c]) and dKer ([c,m]x[m,k]) -- so the weight-gradient
    reduction of pure data parallelism is priced in (it is dKer's
    contraction-axis term).  Serving prices only the forward op.

    ``budget_elems`` is this weight's share of per-device memory (Eq. 11's
    residency constraint g_D <= M_D spread over the model's weights): a
    replicated weight whose shard exceeds it is infeasible.
    ``mem_elems`` is the fast memory of the tile choice (the default
    device's, :func:`device_budget`)."""
    if mem_elems is None:
        mem_elems = device_budget()[1]
    tokens = max(tokens, 1)
    dp = data * pod
    best, best_cost = None, float("inf")
    for where in ("bhw", "k", "c"):
        pbhw = dp * (model if where == "bhw" else 1)
        pk = model if where == "k" else 1
        pc = model if where == "c" else 1
        shard_elems = (cin * cout) / (pk * pc)
        if shard_elems > budget_elems and where == "bhw":
            continue
        cost = _op_cost(tokens, cout, cin, pbhw, pk, pc, mem_elems)
        if train:
            cost += _op_cost(tokens, cin, cout, pbhw, pc, pk, mem_elems)
            cost += _op_cost(cin, cout, tokens, pc, pk, pbhw, mem_elems)
        if cost < best_cost:
            best, best_cost = where, cost
    return best or "k"


def decide_model_axis(cfg_tokens: int, cin: int, cout: int, mesh, *,
                      train: bool = True, budget_elems: int = 1 << 62,
                      mem_elems: Optional[int] = None) -> str:
    shape = mesh_shape(mesh)
    return _decide(cfg_tokens, cin, cout, shape.get("data", 1),
                   shape.get("model", 1), shape.get("pod", 1), train,
                   budget_elems, mem_elems)


# --------------------------------------------------------------------------
# Parameter specs
# --------------------------------------------------------------------------

# weight kinds: path regex -> (cin_dim, cout_dim) of the unstacked tensor.
_MATMUL_KINDS = [
    (r"attn/wq$", (0, 1)), (r"attn/wk$", (0, 1)), (r"attn/wv$", (0, 1)),
    (r"attn/wo$", (0, 1)),
    (r"xattn/wq$", (0, 1)), (r"xattn/wk$", (0, 1)), (r"xattn/wv$", (0, 1)),
    (r"xattn/wo$", (0, 1)),
    (r"mlp/w_up$", (0, 1)), (r"mlp/w_gate$", (0, 1)),
    (r"mlp/w_down$", (0, 1)),
    (r"mlstm/w_x$", (0, 1)), (r"mlstm/w_z$", (0, 1)),
    (r"mlstm/wq$", (0, 1)), (r"mlstm/wk$", (0, 1)), (r"mlstm/wv$", (0, 1)),
    (r"mlstm/out_proj$", (0, 1)),
    (r"mamba/w_z$", (0, 1)), (r"mamba/w_x$", (0, 1)),
    (r"mamba/w_dt$", (0, 1)), (r"mamba/out_proj$", (0, 1)),
    (r"slstm/w_in$", (0, 1)), (r"slstm/out_proj$", (0, 1)),
]

# MoE expert weights: [E, cin, cout] -- expert dim over model (EP);
# the router stays replicated.
_MOE_RE = re.compile(r"moe/(w_gate|w_up|w_down)$")


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def _leaves(tree, prefix: Tuple[str, ...] = (), n_layers=None):
    """``(reference name, layers it is stacked over or None, leaf)`` of
    every leaf of a tree of dicts and lists, in ``torch.utils._pytree``
    order; a layer list's index is left out of the name."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),), n_layers)
    elif isinstance(tree, (list, tuple)):
        stacked = len(prefix) == 1 and prefix[0] in _STACKED
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix if stacked else prefix + (str(i),),
                               len(tree) if stacked else n_layers)
    elif tree is not None:
        yield "/".join(prefix), n_layers, tree


def _rebuild(tree, it):
    """``tree``'s structure with its leaves drawn from ``it`` in order."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return None if tree is None else next(it)


def param_specs(cfg, params_shape: Any, mesh, *, tokens_per_step: int,
                train: bool = True, hbm_bytes: Optional[float] = None,
                mem_elems: Optional[int] = None) -> Any:
    """A spec for every leaf of a parameter tree (tensors, meta tensors or
    anything with ``.shape``), in the same structure.  ``hbm_bytes`` and
    ``mem_elems`` default to :func:`device_budget` of the default device;
    the decisions are kept on ``param_specs.last_decisions``."""
    if hbm_bytes is None or mem_elems is None:
        dev_bytes, dev_elems = device_budget()
        hbm_bytes = dev_bytes if hbm_bytes is None else hbm_bytes
        mem_elems = dev_elems if mem_elems is None else mem_elems
    shape_of = mesh_shape(mesh)
    has_model = shape_of.get("model", 1) > 1
    fsdp_ax = "data" if (cfg.fsdp and shape_of.get("data", 1) > 1) else None
    decisions: Dict[str, str] = {}
    leaves = list(_leaves(params_shape))

    # Eq. 11 residency budget: each weight's fair share of the usable
    # memory, at the training (param + grad + AdamW f32 = 14 B/elem) or
    # serving (2 B/elem) state size.
    total_elems = sum(math.prod(leaf.shape) for _, _, leaf in leaves)
    hbm_usable = HBM_USABLE_FRACTION * hbm_bytes
    state_bytes = 14.0 if train else 2.0

    def spec_for(name: str, n_layers, leaf) -> tuple:
        shape = tuple(leaf.shape)
        nd = len(shape)

        def build(model_dim: Optional[int], fsdp_dim: Optional[int]):
            spec = [None] * nd
            if model_dim is not None and has_model \
                    and shape[model_dim] % shape_of["model"] == 0:
                spec[model_dim] = "model"
            if fsdp_dim is not None and fsdp_ax is not None \
                    and shape[fsdp_dim] % shape_of[fsdp_ax] == 0 \
                    and spec[fsdp_dim] is None:
                spec[fsdp_dim] = fsdp_ax
            return tuple(spec)

        def divisible(dim: int) -> bool:
            return has_model and shape[dim] % shape_of["model"] == 0

        # embeddings: vocab over model; the d_model dim if the vocab does
        # not divide.
        if name.endswith("emb/tok"):
            return build(0, 1) if divisible(0) else build(1, 0)
        if name.endswith("emb/lm_head"):
            return build(1, 0) if divisible(1) else build(0, 1)

        # MoE experts: expert dim over model; fsdp on cin
        if _MOE_RE.search(name):
            return build(0, 1)

        for pat, (ci, co) in _MATMUL_KINDS:
            if re.search(pat, name):
                cin, cout = shape[ci], shape[co]
                n_elems = math.prod(shape) * (n_layers or 1)
                budget = int(hbm_usable * (n_elems / total_elems)
                             / state_bytes / max(n_layers or 1, 1))
                where = decide_model_axis(tokens_per_step, cin, cout,
                                          shape_of, train=train,
                                          budget_elems=budget,
                                          mem_elems=mem_elems)
                # An output projection consumes the sharding its producer
                # emits: wo pairs with wq, w_down with w_up, out_proj with
                # wq / w_x.  A 'k' producer emits feature-sharded
                # activations, so the consumer takes 'c' (row parallel,
                # one psum) instead of an activation all-gather.
                base = name.rsplit("/", 1)[0]
                if name.endswith(("/wo", "/out_proj", "/w_down")):
                    producers = ([base + "/wq"] if name.endswith("/wo")
                                 else [base + "/w_up"]
                                 if name.endswith("/w_down")
                                 else [base + "/wq", base + "/w_x"])
                    producer = next((decisions[p] for p in producers
                                     if p in decisions), None)
                    if producer == "k" and divisible(ci):
                        where = "c"
                    elif producer == "bhw":
                        where = "bhw"
                # divisibility fallback chain: chosen -> other -> replicate
                if where == "k" and not divisible(co):
                    where = "c" if divisible(ci) else "bhw"
                elif where == "c" and not divisible(ci):
                    where = "k" if divisible(co) else "bhw"
                decisions[name] = where
                if where == "k":
                    return build(co, ci)
                if where == "c":
                    return build(ci, co)
                return build(None, ci)

        # norms / scalars / conv kernels / router: replicated
        return (None,) * nd

    # two passes: the producers first, so the consumers pair with them
    # whatever the tree's order.
    paired = ("/wo", "/out_proj", "/w_down")
    for name, n_layers, leaf in leaves:
        if not name.endswith(paired):
            spec_for(name, n_layers, leaf)
    specs = [spec_for(*x) for x in leaves]
    param_specs.last_decisions = decisions
    return _rebuild(params_shape, iter(specs))


param_specs.last_decisions = {}


def flat_specs(spec_tree) -> list:
    """The specs of a spec tree in leaf order (``torch.utils._pytree``'s
    order of the parameter tree it was built from; a ``None`` subtree has
    none)."""
    if spec_tree is None:
        return []
    if _is_spec(spec_tree):
        return [spec_tree]
    if isinstance(spec_tree, dict):
        spec_tree = list(spec_tree.values())
    return [s for t in spec_tree for s in flat_specs(t)]


def param_shapes(cfg) -> Any:
    """The parameter tree of ``cfg`` as meta tensors: shapes and dtypes,
    no storage (a full-width qwen3-moe-235b-a22b has 235B parameters)."""
    import torch

    from repro_torch.models.api import model_fns
    return model_fns(cfg).init(torch.Generator(), cfg, device="meta")


# --------------------------------------------------------------------------
# Batch / cache specs
# --------------------------------------------------------------------------

def dp_axes(mesh, *, include_model: bool = False) -> Tuple[str, ...]:
    shape = mesh_shape(mesh)
    names = ("pod", "data", "model") if include_model else ("pod", "data")
    return tuple(a for a in names if shape.get(a, 1) > 1)


def pure_dp(decisions: Dict[str, str]) -> bool:
    """True when the synthesizer put every matmul in the 'bhw' (2D/DP)
    regime -- the model axis then carries batch, the paper's P_bhw = P
    prescription for small models."""
    return bool(decisions) and all(v == "bhw" for v in decisions.values())


def _batch_axes(mesh, batch: int, include_model: bool):
    shape = mesh_shape(mesh)
    use: Tuple[str, ...] = ()
    rem = batch
    for a in dp_axes(mesh, include_model=include_model):
        if rem % shape[a] == 0:
            use = use + (a,)
            rem //= shape[a]
    return use


def batch_specs(cfg, mesh, batch: Dict[str, Any], *, global_batch: int,
                include_model: bool = False) -> Dict[str, tuple]:
    """Dim 0 of every batch leaf over as many data axes as divide
    ``global_batch``; the rest replicated."""
    use = _batch_axes(mesh, global_batch, include_model)
    bspec = use if len(use) != 1 else use[0]

    def spec_for(leaf):
        nd = len(leaf.shape)
        if not use:
            return (None,) * nd
        return (bspec,) + (None,) * (nd - 1)

    return _rebuild(batch, iter([spec_for(leaf)
                                 for _, _, leaf in _leaves(batch)]))


def cache_specs(cfg, mesh, cache: Any, *, batch: int,
                include_model: bool = False) -> Any:
    """KV caches: batch over the data axes, the cache SEQUENCE over the
    model axis (flash-decoding style sequence parallelism).  SSM states:
    batch over data, the head dim over model when it divides."""
    shape_of = mesh_shape(mesh)
    use = _batch_axes(mesh, batch, include_model)
    bspec = (use if len(use) != 1 else use[0]) if use else None
    model = "model" if (shape_of.get("model", 1) > 1
                        and not include_model) else None
    msize = shape_of.get("model", 1)

    def spec_for(name, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        if nd == 0:
            return ()
        stacked = int(nd >= 4)  # [L, B, ...] layouts
        spec = [None] * nd
        if bspec is not None and nd > stacked:
            spec[stacked] = bspec
        if name.split("/")[-1] in ("k", "v", "xk", "xv") and nd >= 4:
            # [L, B, S, G, hd]: sequence over model
            if model and shape[stacked + 1] % msize == 0:
                spec[stacked + 1] = model
        elif "ssd" in name and nd >= 4:
            # [L, B, H, N, P]: heads over model
            if model and shape[stacked + 1] % msize == 0:
                spec[stacked + 1] = model
        elif name.startswith("conv") and nd >= 3:
            if model and shape[-1] % msize == 0:
                spec[-1] = model
        return tuple(spec)

    return _rebuild(cache, iter([spec_for(name, leaf)
                                 for name, _, leaf in _leaves(cache)]))


def named(mesh, spec_tree) -> Any:
    """Every spec of ``spec_tree`` as the DTensor placements it gives on
    the ``DeviceMesh`` ``mesh`` (the reference's ``NamedSharding``s)."""
    from repro_torch.dist.collectives import placements

    def walk(t):
        if _is_spec(t):
            return placements(mesh, t)
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return t

    return walk(spec_tree)

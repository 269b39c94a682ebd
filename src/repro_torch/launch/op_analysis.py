"""Per-device FLOPs, memory traffic, collective wire bytes and live memory
of one step, read from the eager ops it runs -- what
``repro/launch/hlo_analysis.py::analyze_hlo`` is to the reference, which
reads them from compiled HLO.

:class:`OpCounter` is a dispatch mode.  On placed state (DTensors) it
lets DTensor plan every op and counts the ops DTensor then runs on this
rank's blocks, so every count is per device; it skips the global-shape
ops DTensor's sharding propagation runs on fake tensors.  A replicated op
costs every device its whole count.  The dry run's blocks live on the
``meta`` device, so nothing is computed and nothing is allocated: the
counts are those of the real step on a device of the mesh.
:class:`DotCheck` (inside the counter in :func:`analyze`) records any
product that reaches DTensor's sharding propagation: the port runs every
product on each rank's blocks, so the split it counts is the port's own.

Accounting model (per device, the reference's where it can be):
  flops   -- dot (``mm``, ``bmm``, ``addmm``, ``baddbmm``):
             ``2 * |out| * K``; conv: ``2 * |out| * cin / groups * k``;
             every other op: ``|out|`` (a floor; dots dominate).  The dot
             count equals ``torch.utils.flop_counter``'s.
  bytes   -- every op's tensor operands plus its result.  The eager port
             fuses nothing, so that is what it moves, where the
             reference's count stops at XLA's fusion boundaries.  Views
             and metadata ops move nothing; a gather (``index``,
             ``embedding``) moves twice its result; an indexed write
             (``index_put_``) twice its values.
  wire    -- the ring model of each collective's payload ``V`` and group
             size ``g`` (``repro/launch/dryrun.py``): all-gather
             ``V * (g - 1) / g`` (``V`` the gathered result),
             reduce-scatter ``result * (g - 1)``, all-reduce
             ``2 * V * (g - 1) / g``, all-to-all ``V * (g - 1) / g``,
             collective-permute ``V``.  Every collective DTensor issues
             counts, its implicit redistributions included.
  memory  -- the bytes of every storage the step's ops create, tracked
             until it is freed: ``temp`` is the peak of those live
             bytes over the step; the arguments are the placed state
             the step starts from.
A Python loop runs unrolled in eager mode: there are no trip counts.
"""

from __future__ import annotations

import math
import weakref
from typing import Any, Dict, Iterable

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

#: functional collectives: op name -> kind
_COLL_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}
_FREE_OPS = {"wait_tensor", "_wrap_tensor_autograd", "detach", "alias",
             "_unsafe_view", "lift_fresh"}
_DOTS = {"mm": 0, "addmm": 1, "bmm": 0, "baddbmm": 1}
_GATHERS = {"index", "embedding", "gather", "index_select"}
_INDEXED_WRITES = {"index_put_", "index_put", "_index_put_impl_",
                   "index_copy_", "scatter_", "masked_scatter_"}


def ring_wire(kind: str, nbytes: float, g: int) -> float:
    """Per-device wire bytes of one collective of kind ``kind`` (one of
    :data:`COLLECTIVES`) over ``g`` ranks, ``nbytes`` being the buffer
    the reference's ``parse_collectives`` reads: the gathered result of
    an all-gather, the scattered result of a reduce-scatter, the operand
    of the others."""
    if kind == "all-gather":
        return nbytes * (g - 1) / max(g, 1)
    if kind == "reduce-scatter":
        return nbytes * (g - 1)
    if kind == "all-reduce":
        return 2 * nbytes * (g - 1) / max(g, 1)
    if kind == "all-to-all":
        return nbytes * (g - 1) / max(g, 1)
    if kind == "collective-permute":
        return nbytes
    raise ValueError(f"unknown collective kind {kind!r}")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _is_view(func) -> bool:
    """True for an op whose result aliases an input without writing it."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _in_place(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and any(r.alias_info is not None
                              and r.alias_info.is_write for r in rets)


def storage_key(t: torch.Tensor) -> int:
    """The identity of ``t``'s storage (shared by all its views)."""
    return t.untyped_storage()._cdata


class OpCounter(TorchDispatchMode):
    """Counts the local ops run inside it (see the module docstring).

    ``flops``, ``dot_flops``, ``bytes``, ``collectives`` (``(kind,
    payload bytes, group size)`` of each, in order; see
    :func:`parse_collectives`), ``by_op`` (``{op: [calls, flops,
    bytes]}``) and the memory: ``temp_peak_bytes``, and ``live_bytes``
    now.  Storages named by :meth:`hold` (the arguments) are not counted
    as temporaries."""

    def __init__(self, sites: bool = False):
        super().__init__()
        self.flops = 0.0
        self.dot_flops = 0.0
        self.bytes = 0.0
        self.collectives: list = []
        self.by_op: Dict[str, list] = {}
        #: dot FLOPs by where the port ran the dot (``sites=True``): the
        #: innermost frames of its models, or the backward node's name
        self.dot_sites: Dict[str, float] = {} if sites else None
        self.live_bytes = 0
        self.temp_peak_bytes = 0
        self._known: Dict[int, int] = {}
        self._memo: Dict[tuple, tuple] = {}

    # ------------------------------------------------------- memory --
    def hold(self, tensors: Iterable[torch.Tensor]) -> None:
        """Mark the storages of ``tensors`` as existing before the step."""
        for t in tensors:
            self._known.setdefault(storage_key(t), 0)

    def _freed(self, key: int, nbytes: int) -> None:
        if self._known.pop(key, None) is not None:
            self.live_bytes -= nbytes

    def _track(self, outs) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._known:
                continue
            n = st.nbytes()
            self._known[key] = n
            self.live_bytes += n
            weakref.finalize(st, self._freed, key, n)
        self.temp_peak_bytes = max(self.temp_peak_bytes, self.live_bytes)

    def held_bytes(self, tensors: Iterable[torch.Tensor]) -> int:
        """Bytes of the distinct storages of ``tensors`` that the step
        created (its outputs, beside the arguments it updated)."""
        seen = {}
        for t in tensors:
            key = storage_key(t)
            if self._known.get(key):
                seen[key] = self._known[key]
        return sum(seen.values())

    # -------------------------------------------------------- counts --
    def _count(self, name: str, flops: float, nbytes: float,
               dot: float = 0.0) -> None:
        row = self.by_op.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        self.flops += flops
        self.dot_flops += dot
        self.bytes += nbytes
        if dot and self.dot_sites is not None:
            site = " < ".join(reversed(_port_frames(2)))
            self.dot_sites[site] = self.dot_sites.get(site, 0.0) + dot

    def _collective(self, func, name: str, args, out) -> None:
        from repro_torch.dist.collectives import group_size
        kind = _COLL_OPS[name]
        inp = args[0]
        if kind == "all-gather":
            g = int(args[1])
        elif kind == "reduce-scatter":
            g = int(args[2])
        else:
            g = group_size(args[-1])
        res = _tensors(out)
        v = _nbytes(res[0] if kind in ("all-gather", "reduce-scatter")
                    else inp)
        self.collectives.append((kind, v, g))
        self._count(str(func), 0.0, _nbytes(inp) + sum(map(_nbytes, res)))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented   # DTensor plans it, then runs its blocks
        if any(issubclass(t, FakeTensor) for t in types):
            return func(*args, **kwargs)   # sharding propagation
        kind = _op_kind(func)
        if kind == "pure":
            leaves, _ = pytree.tree_flatten((args, kwargs))
            ts = [t for t in leaves if isinstance(t, torch.Tensor)]
            if ts and all(type(t) is torch.Tensor and t.device.type == "meta"
                          for t in ts):
                return self._meta_pure(func, leaves, args, kwargs)
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if any(isinstance(t, FakeTensor) for t in outs):
            return out              # sharding propagation: global shapes
        name = func._schema.name.split("::")[-1]
        if kind == "collective":
            self._collective(func, name, args, out)
        elif kind == "free" or not outs:
            return out
        else:
            ins = _tensors((args, kwargs))
            self._count(str(func), *_cost(name, args, ins, outs))
        if kind != "in_place":
            self._track(outs)
        return out

    def _meta_pure(self, func, leaves, args, kwargs):
        """A functional op on ``meta`` blocks.  Its result and cost depend
        only on the operands' shapes, strides and dtypes and the other
        arguments: the first call of each signature runs the meta kernel,
        later ones build the result from the recorded shapes (a layer
        repeats every op of the one before it)."""
        key = (func,) + tuple(
            (tuple(t.shape), t.stride(), t.dtype) if isinstance(
                t, torch.Tensor) else t for t in leaves)
        hit = self._memo.get(key) if _hashable(key) else None
        if hit is None:
            out = func(*args, **kwargs)
            outs = _tensors(out)
            if any(type(t) is not torch.Tensor or t.device.type != "meta"
                   for t in outs):
                raise TypeError(f"{func} on meta blocks made {outs}")
            name = func._schema.name.split("::")[-1]
            cost = _cost(name, args, _tensors(leaves), outs) if outs \
                else None
            flat, spec = pytree.tree_flatten(out)
            hit = (spec, [(tuple(t.shape), t.stride(), t.dtype)
                          if isinstance(t, torch.Tensor) else t
                          for t in flat], cost)
            if _hashable(key):
                self._memo[key] = hit
        else:
            spec, flat, cost = hit
            out = pytree.tree_unflatten(
                [torch.empty_strided(x[0], x[1], dtype=x[2], device="meta")
                 if isinstance(x, tuple) else x for x in flat], spec)
            outs = _tensors(out)
        if cost is not None:
            self._count(str(func), *cost)
            self._track(outs)
        return out


def _hashable(key) -> bool:
    try:
        hash(key)
    except TypeError:
        return False
    return True


_KINDS: Dict[Any, str] = {}


def _op_kind(func) -> str:
    """``collective``, ``free`` (a view or metadata op: moves nothing),
    ``in_place`` (writes an operand) or ``pure`` (makes new tensors)."""
    kind = _KINDS.get(func)
    if kind is None:
        name = func._schema.name.split("::")[-1]
        if func.namespace in ("_c10d_functional",
                              "_c10d_functional_autograd") \
                and name in _COLL_OPS:
            kind = "collective"
        elif name in _FREE_OPS or _is_view(func):
            kind = "free"
        elif _in_place(func):
            kind = "in_place"
        else:
            kind = "pure"
        _KINDS[func] = kind
    return kind


def _cost(name: str, args, ins, outs):
    """(flops, bytes, dot flops) of one local op."""
    o = outs[0]
    moved = float(sum(map(_nbytes, ins)) + sum(map(_nbytes, outs)))
    if name in _DOTS:
        a = args[_DOTS[name]]
        dot = 2.0 * o.numel() * a.shape[-1]
        return dot + (o.numel() if _DOTS[name] else 0), moved, dot
    if name == "convolution":
        w = args[1]
        dot = 2.0 * o.numel() * w.shape[1] * math.prod(w.shape[2:])
        return dot, moved, dot
    if name in _GATHERS:
        idx = sum(_nbytes(t) for t in ins[1:] if not t.is_floating_point())
        return float(o.numel()), 2.0 * _nbytes(o) + idx, 0.0
    if name in _INDEXED_WRITES:
        vals = ins[-1]
        idx = sum(_nbytes(t) for t in ins[1:-1])
        return float(vals.numel()), 2.0 * _nbytes(vals) + idx, 0.0
    return float(sum(t.numel() for t in outs)), moved, 0.0


def strict_view_refusal(placements, shape, new_shape,
                        mesh_sizes) -> list:
    """Why torch 2.11's DTensor refuses a ``view`` (or ``_unsafe_view``)
    of a tensor of global ``shape``, placed by ``placements`` on a mesh
    of ``mesh_sizes``, to ``new_shape``: one line per refusal, none when
    it takes the view.  Its rule (``_view_ops.propagate_shape_and_
    sharding`` with ``strict_view``, which may not redistribute) keeps a
    flattened group split only through the group's leading dim, split
    evenly, and a split dim only through its leading piece, divisible by
    the mesh dim; torch 2.13 also carries a split non-leading dim
    (``_StridedShard``).  The dims map as both versions' ``view_groups``
    maps them."""
    from torch.distributed.tensor._ops._view_ops import (Flatten, InputDim,
                                                         Split, view_groups)
    why = []

    def mesh_dim_of(dim):
        # the first mesh dim that splits tensor dim ``dim``, as 2.11 reads
        for i, p in enumerate(placements):
            if p.is_shard() and getattr(p, "dim", None) == dim:
                return i
        return None

    def leading(cmd):
        if isinstance(cmd, InputDim):
            return cmd
        if isinstance(cmd, Flatten):
            dims = [d.input_dim for d in cmd.input_dims]
            for i, dim in enumerate(dims):
                m = mesh_dim_of(dim)
                if m is None:
                    continue
                if i > 0:
                    why.append(f"flattens dim {dim} (split on mesh dim {m}) "
                               f"behind dim {dims[0]}")
                elif shape[dim] % mesh_sizes[m]:
                    why.append(f"flattens dim {dim} of {shape[dim]}, split "
                               f"unevenly on mesh dim {m}")
            return cmd.input_dims[0]
        if isinstance(cmd, Split):
            in_dim = leading(cmd.input_dim)
            if cmd.split_id == 0 and in_dim is not None:
                m = mesh_dim_of(in_dim.input_dim)
                if m is not None and cmd.group_shape[0] % mesh_sizes[m]:
                    why.append(f"splits dim {in_dim.input_dim} (split on "
                               f"mesh dim {m}) into {cmd.group_shape}")
            return in_dim if cmd.split_id == 0 else None
        return None

    # view_groups maps dims: no collective
    rule = view_groups(tuple(shape), tuple(new_shape))  # raw-collective-ok
    for cmd in rule:
        leading(cmd)
    return why


#: the pointwise ops torch 2.11's DTensor lets carry a pending sum
_LINEAR_POINTWISE = ("add.Tensor", "sub.Tensor", "mul.Tensor")


def pending_sum_refusal(placements: list, mesh_sizes) -> list:
    """Why torch 2.11's DTensor refuses a linear pointwise op (``add``,
    ``sub``, ``mul``) of inputs placed by ``placements`` (one list per
    DTensor input): one line per refusal, none when it runs it.  Its rule
    (``_pointwise_ops.pointwise_strategy``) follows the input split into
    the most blocks (the first of a tie) and keeps that input's pending
    sums in the output, so every other input is redistributed to a
    pending sum on those mesh dims; from a split that is not implemented
    (``redistribute from S to P not supported yet``).  Torch 2.13 weighs
    other layouts and runs it."""
    def blocks(pl):
        n = 1
        for p, size in zip(pl, mesh_sizes):
            if p.is_shard():
                n *= size
        return n

    followed = max(range(len(placements)),
                   key=lambda i: (blocks(placements[i]), -i))
    why = []
    for m, p in enumerate(placements[followed]):
        if not (p.is_partial("sum") or p.is_partial("avg")):
            continue
        for i, other in enumerate(placements):
            if i != followed and other[m].is_shard():
                why.append(f"input {i}'s split on mesh dim {m} made a "
                           f"pending sum to follow input {followed}")
    return why


class ViewCheck(TorchDispatchMode):
    """Records every DTensor op run inside it that torch 2.11's DTensor
    would refuse: a view (:func:`strict_view_refusal`) and a linear
    pointwise op (:func:`pending_sum_refusal`), with its inputs' global
    shapes and placements, the view's shape and where it ran in the port
    (``refused``: one dict each).  It changes nothing: every op runs as
    it would without it."""

    def __init__(self):
        super().__init__()
        self.refused: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if func in (torch.ops.aten.view.default,
                    torch.ops.aten._unsafe_view.default) \
                and isinstance(args[0], DTensor):
            x, new_shape = args[0], tuple(args[1])
            why = strict_view_refusal(x.placements, tuple(x.shape),
                                      new_shape, x.device_mesh.shape)
            if why:
                self.refused.append({
                    "op": str(func), "shape": tuple(x.shape),
                    "placements": str(x.placements),
                    "new_shape": new_shape, "why": why,
                    "at": _port_frames()})
        elif func.namespace == "aten" and func.__name__ in _LINEAR_POINTWISE:
            ts = [a for a in args if isinstance(a, DTensor)]
            if len(ts) > 1:
                why = pending_sum_refusal([t.placements for t in ts],
                                          ts[0].device_mesh.shape)
                if why:
                    self.refused.append({
                        "op": str(func),
                        "shape": tuple(tuple(t.shape) for t in ts),
                        "placements": str([t.placements for t in ts]),
                        "why": why, "at": _port_frames()})
        return func(*args, **kwargs)


class DotCheck(TorchDispatchMode):
    """Records every dot (``mm``, ``bmm``, ``addmm``, ``baddbmm``; an
    ``einsum`` or ``matmul`` of DTensors arrives as one) that reaches it
    with a DTensor operand: a product whose split DTensor's sharding
    propagation chooses, a choice that differs between torch versions
    and shapes.  A product run on each rank's blocks
    (``collectives.local_map``) reaches it with plain blocks and is not
    recorded.  Each record (``left``: one dict each) holds the op, its
    operands' global shapes and placements and where it ran in the port.
    It changes nothing: every op runs as it would without it."""

    def __init__(self):
        super().__init__()
        self.left: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if func.namespace == "aten" and func.__name__.split(".")[0] in _DOTS:
            ts = [a for a in args if isinstance(a, torch.Tensor)]
            if any(isinstance(t, DTensor) for t in ts):
                self.left.append({
                    "op": str(func),
                    "shape": tuple(tuple(t.shape) for t in ts),
                    "placements": str([getattr(t, "placements", None)
                                       for t in ts]),
                    "at": _port_frames()})
        return func(*args, **kwargs)


def _port_frames(n: int = 3) -> list:
    """The innermost ``n`` frames of the port's models on the stack
    (``file:line function``) above any ``local_map``: a function run on
    each rank's blocks is named by where the port called it."""
    import os
    import traceback
    frames = []
    for f in traceback.extract_stack():
        if f"experimental{os.sep}_func_map" in f.filename:
            break
        if f"repro_torch{os.sep}models" in f.filename:
            frames.append(f)
    node = torch._C._current_autograd_node()
    return ([f"backward: {node.name()}"] if node is not None else []) + [
        f"{os.path.basename(f.filename)}:{f.lineno} {f.name}"
        for f in frames[-n:]]


def parse_collectives(events) -> Dict[str, Any]:
    """Per-kind wire-byte totals and counts of recorded collectives
    (``OpCounter.collectives``), by :func:`ring_wire` -- the keys of the
    reference's ``parse_collectives``."""
    out = {k: 0.0 for k in COLLECTIVES}
    counts = {k: 0 for k in COLLECTIVES}
    for kind, nbytes, g in events:
        out[kind] += ring_wire(kind, nbytes, g)
        counts[kind] += 1
    return {"wire_bytes": out, "counts": counts,
            "total_wire_bytes": sum(out.values())}


def analyze(step, args: Any, *, hold: Any = None,
            sites: bool = False) -> Dict[str, Any]:
    """Run ``step(*args)`` under an :class:`OpCounter` and return the
    reference's ``analyze_hlo`` keys (``flops``, ``hbm_bytes``,
    ``wire_bytes``, ``coll_counts``, ``total_wire_bytes``) with the dot
    FLOPs, the per-op table, the argument, output and temp bytes, and
    the step's output.  ``hold`` (default ``args``) is the state the step
    starts from: its argument bytes are its blocks' bytes on this
    device.  ``sites`` adds ``dot_sites``, the dot FLOPs by where the
    port ran each dot (:attr:`OpCounter.dot_sites`).  The step also runs
    under a :class:`DotCheck`: ``dots_left`` holds its records."""
    from repro_torch.dist.collectives import local_part
    held = [local_part(t) for t in _tensors(args if hold is None else hold)]
    counter = OpCounter(sites=sites)
    counter.hold(held)
    check = DotCheck()
    # the check inside the counter: it sees each op before DTensor does
    with counter, check:
        out = step(*args)
    outs = [local_part(t) for t in _tensors(out)]
    coll = parse_collectives(counter.collectives)
    return {
        "flops": counter.flops,
        "dot_flops": counter.dot_flops,
        "hbm_bytes": counter.bytes,
        "wire_bytes": coll["wire_bytes"],
        "coll_counts": coll["counts"],
        "total_wire_bytes": coll["total_wire_bytes"],
        "by_op": counter.by_op,
        "argument_size_in_bytes": sum(_nbytes(t) for t in
                                      {id(t): t for t in held}.values()),
        "output_size_in_bytes": counter.held_bytes(outs),
        "temp_size_in_bytes": counter.temp_peak_bytes,
        **({"dot_sites": counter.dot_sites} if sites else {}),
        "dots_left": check.left,
        "out": out,
    }

"""Train-step assembly -- the port of ``repro/train/step.py``: gradients
of a loss, microbatch accumulation, optional int8 gradient compression
over one mesh axis, and the optimizer update.

``make_train_step(loss_fn, optimizer)`` returns ``train_step(state,
batch) -> (state, metrics)``, a function of its inputs (the state is not
updated in place).  ``mode`` is the reference's (:data:`MODES`):

* ``"gspmd"`` (default): autograd of the loss.  On one rank with plain
  tensors that is the reference's GSPMD step, whose sharding is then the
  identity.  :func:`place_gspmd` does what the reference's
  ``launch/dryrun.py::build_train`` assembles: it decides every
  parameter's spec (``parallel.sharding.param_specs``), pins the
  attention mesh, and places the state as DTensors on a ``("data",
  "model")`` (or ``("pod", "data", "model")``) ``DeviceMesh``; its
  ``place_batch`` places a batch by ``batch_specs``.  On placed state the
  step runs the loss on DTensors (their sharding propagation issues the
  collectives XLA would), redistributes each gradient to its parameter's
  placements -- the reduce-scatter / all-reduce the reference's XLA
  emits -- and updates the placed parameters and AdamW moments; ``loss``,
  ``grad_norm`` and ``step`` come out replicated, as plain tensors.
  Every family runs so: the recurrences of the ssm and hybrid families
  run on each rank's blocks (``models.ssm._pinned_recurrence``).  With
  ``compress_axis=`` (and the mesh that names it) each rank's gradients
  of plain parameters are mean-reduced over that axis by
  ``dist.compress.compressed_psum_tree`` (int8, error feedback carried in
  ``TrainState.err``) before the update: data parallelism over the axis,
  each rank passing its own batch.  On more than one rank, a step on
  plain parameters without ``compress_axis`` raises ``ValueError``: it
  would train each rank on its own;
* ``"dist-grid"``: the loss runs through the ``dist`` ops
  (``dist.train.make_grid_train_step``), whose backward passes and glue
  already leave the complete gradient of every parameter on every rank,
  so the step adds no collective and every rank runs the same AdamW
  update on the same full parameters; compression is refused, as the
  reference refuses it.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.train.optim import AdamW, AdamWState, global_norm


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    err: Any = None          # error-feedback state when compression is on


MODES = ("gspmd", "dist-grid")

PLACE_FIRST = ("mode='gspmd' on more than one rank needs placed state: "
               "place the parameters and the batch with "
               "train.step.place_gspmd (or pass compress_axis= for data "
               "parallelism on plain parameters)")

class GspmdPlacement(NamedTuple):
    """What :func:`place_gspmd` assembles: the placed state, the mesh, the
    parameter and batch specs, the sharding decisions and whether the
    model axis carries batch (``dp_all``)."""
    state: TrainState
    mesh: Any
    param_specs: Any
    batch_specs: Dict
    decisions: Dict
    dp_all: bool

    def place_batch(self, batch: Dict) -> Dict:
        """A global batch (the same on every rank) placed by the batch
        specs: each rank keeps its block."""
        from repro_torch.dist.collectives import place
        return {k: place(v, self.mesh, self.batch_specs[k])
                for k, v in batch.items()}


def place_gspmd(cfg, mesh, state: TrainState, batch: Dict, *,
                hbm_bytes: Optional[float] = None,
                mem_elems: Optional[int] = None) -> GspmdPlacement:
    """The reference's ``build_train`` assembly on a ``DeviceMesh``:
    ``param_specs`` at the batch's tokens per step, ``pure_dp``, the
    attention mesh over ``("pod", "data", "model")`` when every matmul is
    data parallel (else ``("pod", "data")``), ``batch_specs`` (the model
    axis carrying batch under ``pure_dp``), and ``state`` (whole tensors,
    the same on every rank: a fresh ``init_train_state`` or a restored
    checkpoint) placed: the parameters and both AdamW moments by the
    parameters' specs.  ``batch`` is a batch of the global shape (its
    values are not read).  The memory budget defaults to the mesh's
    device's (``parallel.sharding.device_budget``)."""
    from repro_torch.models import layers as L
    from repro_torch.parallel import sharding as shd

    global_batch, seq = batch["tokens"].shape[:2]
    pspecs = shd.param_specs(cfg, state.params, mesh,
                             tokens_per_step=global_batch * seq,
                             **_budget(mesh, hbm_bytes, mem_elems))
    decisions = dict(shd.param_specs.last_decisions)
    dp_all = shd.pure_dp(decisions)
    L.set_attention_mesh(
        mesh, ("pod", "data", "model") if dp_all else ("pod", "data"))
    bspecs = shd.batch_specs(cfg, mesh, batch, global_batch=global_batch,
                             include_model=dp_all)
    if state.err is not None:
        raise ValueError("a compressed state (err) is data parallel over "
                         "its own axis; place_gspmd takes state without it")
    state = TrainState(params=_place_tree(state.params, pspecs, mesh),
                       opt=state.opt._replace(
                           m=_place_tree(state.opt.m, pspecs, mesh),
                           v=_place_tree(state.opt.v, pspecs, mesh)))
    return GspmdPlacement(state, mesh, pspecs, bspecs, decisions, dp_all)


class ServePlacement(NamedTuple):
    """What :func:`place_serve` assembles: the placed parameters, cache and
    inputs, the mesh, their specs, the sharding decisions and whether the
    model axis carries batch (``dp_all``)."""
    params: Any
    cache: Any
    inputs: Dict
    mesh: Any
    param_specs: Any
    cache_specs: Any
    input_specs: Dict
    decisions: Dict
    dp_all: bool


def place_serve(cfg, mesh, params, cache, inputs: Dict, *,
                tokens_per_step: int, hbm_bytes: Optional[float] = None,
                mem_elems: Optional[int] = None) -> ServePlacement:
    """The reference's ``launch/dryrun.py::build_prefill`` /
    ``build_decode`` assembly on a ``DeviceMesh``: ``param_specs`` for
    serving (``train=False``) at ``tokens_per_step`` (a prefill's batch
    times its prompt, a decode step's batch), ``pure_dp``, the attention
    mesh pinned as :func:`place_gspmd` pins it, the cache placed by
    ``cache_specs`` and the inputs (tokens, frames) by ``batch_specs``
    over the cache's batch, the model axis carrying batch under
    ``pure_dp``.  ``params``, ``cache`` and ``inputs`` are whole tensors,
    the same on every rank (or ``meta`` tensors).  Run the family's
    ``prefill`` / ``decode_step`` on the result under ``torch.no_grad()``
    and ``collectives.replicated_region()`` (:func:`serve_step`); the
    cache's K/V rows and recurrent states are written on each rank's
    blocks (``layers.write_rows``, ``ssm._placed_step``)."""
    from repro_torch.models import layers as L
    from repro_torch.parallel import sharding as shd

    pspecs = shd.param_specs(cfg, params, mesh,
                             tokens_per_step=tokens_per_step, train=False,
                             **_budget(mesh, hbm_bytes, mem_elems))
    decisions = dict(shd.param_specs.last_decisions)
    dp_all = shd.pure_dp(decisions)
    L.set_attention_mesh(
        mesh, ("pod", "data", "model") if dp_all else ("pod", "data"))
    batch = inputs["tokens"].shape[0]
    cspecs = shd.cache_specs(cfg, mesh, cache, batch=batch,
                             include_model=dp_all)
    ispecs = shd.batch_specs(cfg, mesh, inputs, global_batch=batch,
                             include_model=dp_all)
    return ServePlacement(
        _place_tree(params, pspecs, mesh), _place_tree(cache, cspecs, mesh),
        _place_tree(inputs, ispecs, mesh), mesh, pspecs, cspecs, ispecs,
        decisions, dp_all)


def _budget(mesh, hbm_bytes, mem_elems) -> Dict:
    """``param_specs``' memory budget: the given values, else the mesh's
    device's (``parallel.sharding.device_budget``)."""
    from repro_torch.parallel.sharding import device_budget
    if hbm_bytes is None or mem_elems is None:
        dev_bytes, dev_elems = device_budget(mesh.device_type)
        hbm_bytes = dev_bytes if hbm_bytes is None else hbm_bytes
        mem_elems = dev_elems if mem_elems is None else mem_elems
    return {"hbm_bytes": hbm_bytes, "mem_elems": mem_elems}


def _place_tree(tree, spec_tree, mesh):
    """Every leaf of ``tree`` placed by its spec in ``spec_tree`` (the same
    structure; ``None`` leaves stay ``None``)."""
    from repro_torch.dist.collectives import place
    from repro_torch.parallel import sharding as shd
    placed = [place(t, mesh, s) for (_, _, t), s in
              zip(shd._leaves(tree), shd.flat_specs(spec_tree))]
    return shd._rebuild(tree, iter(placed))


def serve_step(cfg, kind: str) -> Callable:
    """``step(params, cache, inputs) -> (logits, cache)``: the family's
    ``prefill`` (``kind="prefill"``; the encoder-decoder's takes
    ``inputs["frames"]``) or ``decode_step`` (``"decode"``) on
    ``inputs["tokens"]``, without autograd, plain tensors counting as
    replicated beside placed ones."""
    from repro_torch.dist import collectives as C
    from repro_torch.models.api import model_fns
    fns = model_fns(cfg)
    if kind not in ("prefill", "decode"):
        raise ValueError(f"kind must be 'prefill' or 'decode', got {kind!r}")

    def step(params, cache, inputs):
        with torch.no_grad(), C.replicated_region():
            if kind == "decode":
                return fns.decode_step(params, cfg, cache, inputs["tokens"])
            if cfg.family == "encdec":
                return fns.prefill(params, cfg, cache, inputs["frames"],
                                   inputs["tokens"])
            return fns.prefill(params, cfg, cache, inputs["tokens"])

    return step


def _value_and_grad(loss_fn, params, batch, placed: bool = False):
    """The loss and its gradient tree.  On placed (DTensor) parameters the
    model's own plain tensors count as replicated, and each gradient is
    redistributed to its parameter's placements."""
    from repro_torch.dist import collectives as C
    leaves, spec = pytree.tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    region = C.replicated_region() if placed else contextlib.nullcontext()
    with torch.enable_grad(), region:
        loss = loss_fn(pytree.tree_unflatten(leaves, spec), batch)
        grads = torch.autograd.grad(loss, leaves)
    if placed:
        grads = [C.constrain_like(g, p, tag="grad")
                 for g, p in zip(grads, leaves)]
    return loss.detach(), pytree.tree_unflatten(list(grads), spec)


def _check_placed_batch(batch: Dict) -> None:
    from repro_torch.dist.collectives import is_placed
    plain = [k for k, v in batch.items() if not is_placed(v)]
    if plain:
        raise ValueError(f"the state is placed but batch leaves {plain} are "
                         f"plain: place the batch with "
                         f"GspmdPlacement.place_batch (train.step."
                         f"place_gspmd)")


def make_train_step(loss_fn: Callable, optimizer: AdamW, *,
                    n_microbatches: int = 1,
                    compress_axis: Optional[str] = None,
                    compress_mesh=None, mode: str = "gspmd") -> Callable:
    """``loss_fn(params, batch) -> scalar``; batch leaves are
    ``[global_batch, ...]`` and split into ``n_microbatches`` along dim
    0, whose gradients are averaged before the update.  ``compress_axis``
    names an axis of the ``DeviceMesh`` ``compress_mesh`` over which the
    gradients are mean-reduced through the int8 compressor (the state
    then needs ``init_train_state(..., compress=True)``).  ``mode``: see
    the module docstring; the reference's refusals.  On placed state the
    batch must be placed too (``GspmdPlacement.place_batch``), and
    ``n_microbatches`` splits each rank's block of it."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "dist-grid" and compress_axis is not None:
        raise ValueError(
            "compress_axis needs a bound GSPMD mesh axis; in dist-grid "
            "mode the reductions live inside the dist-op VJPs")
    if compress_axis is not None and compress_mesh is None:
        raise ValueError("compress_axis needs the DeviceMesh that names it "
                         "(compress_mesh=)")

    def train_step(state: TrainState, batch: Dict
                   ) -> Tuple[TrainState, Dict]:
        from repro_torch.dist import collectives as C
        placed = C.is_placed(pytree.tree_leaves(state.params)[0])
        if placed and compress_axis is not None:
            raise ValueError("compress_axis reduces plain parameters' "
                             "gradients; placed state reduces them by its "
                             "placements")
        if placed:
            _check_placed_batch(batch)
        elif mode == "gspmd" and compress_axis is None \
                and C.world_size() > 1:
            raise ValueError(PLACE_FIRST)
        if n_microbatches > 1:
            split = (functools.partial(C.split_local, n=n_microbatches)
                     if placed else lambda v: v.chunk(n_microbatches))
            pieces = {k: split(v) for k, v in batch.items()}
            grads, loss = None, 0.0
            for i in range(n_microbatches):
                mb = {k: v[i] for k, v in pieces.items()}
                l_i, g_i = _value_and_grad(loss_fn, state.params, mb,
                                           placed)
                g_i = pytree.tree_map(lambda g: g.float(), g_i)
                grads = g_i if grads is None else pytree.tree_map(
                    torch.add, grads, g_i)
                loss = loss + l_i
            grads = pytree.tree_map(lambda g: g / n_microbatches, grads)
            loss = loss / n_microbatches
        else:
            loss, grads = _value_and_grad(loss_fn, state.params, batch,
                                          placed)
        err = state.err
        if compress_axis is not None:
            from repro_torch.dist.compress import compressed_psum_tree
            grads, err = compressed_psum_tree(grads, compress_mesh,
                                              compress_axis, err)
        params, opt = optimizer.update(grads, state.opt, state.params)
        metrics = {"loss": C.full_tensor(loss.float(), tag="gspmd_metric"),
                   "grad_norm": C.full_tensor(global_norm(grads),
                                              tag="gspmd_metric"),
                   "step": opt.step}
        return TrainState(params=params, opt=opt, err=err), metrics

    return train_step


def init_train_state(params, optimizer: AdamW, *,
                     compress: bool = False) -> TrainState:
    err = (pytree.tree_map(
        lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        if compress else None)
    return TrainState(params=params, opt=optimizer.init(params), err=err)

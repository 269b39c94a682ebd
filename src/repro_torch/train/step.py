"""Train-step assembly -- the port of ``repro/train/step.py``: gradients
of a loss, microbatch accumulation, optional int8 gradient compression
over one mesh axis, and the optimizer update.

``make_train_step(loss_fn, optimizer)`` returns ``train_step(state,
batch) -> (state, metrics)``, a function of its inputs (the state is not
updated in place).  ``mode`` is the reference's (:data:`MODES`):

* ``"gspmd"`` (default): plain autograd of the loss on this rank.  On one
  rank that is the reference's GSPMD step, whose sharding is then the
  identity.  With ``compress_axis=`` (and the mesh that names it) each
  rank's gradients are mean-reduced over that axis by
  ``dist.compress.compressed_psum_tree`` (int8, error feedback carried
  in ``TrainState.err``) before the update: data parallelism over the
  axis, each rank passing its own batch.  On more than one rank without
  ``compress_axis`` the reference shards the step by its GSPMD specs
  (``parallel/sharding.py``), which the port has not yet: it raises;
* ``"dist-grid"``: the loss runs through the ``dist`` ops
  (``dist.train.make_grid_train_step``), whose backward passes and glue
  already leave the complete gradient of every parameter on every rank,
  so the step adds no collective and every rank runs the same AdamW
  update on the same full parameters; compression is refused, as the
  reference refuses it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.train.optim import AdamW, AdamWState, global_norm


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    err: Any = None          # error-feedback state when compression is on


MODES = ("gspmd", "dist-grid")

GSPMD_LATER = ("mode='gspmd' on more than one rank shards the step by the "
               "reference's GSPMD specs (parallel/sharding.py), which the "
               "port has not yet (ROADMAP Queue 1 item 3(e)); pass "
               "compress_axis= for data parallelism, or train on the grid "
               "(mode='dist-grid')")


def _value_and_grad(loss_fn, params, batch):
    leaves, spec = pytree.tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss = loss_fn(pytree.tree_unflatten(leaves, spec), batch)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), pytree.tree_unflatten(list(grads), spec)


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
    the module docstring; the reference's refusals, and
    ``NotImplementedError`` for ``"gspmd"`` on more than one rank without
    ``compress_axis``."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "dist-grid" and compress_axis is not None:
        raise ValueError(
            "compress_axis needs a bound GSPMD mesh axis; in dist-grid "
            "mode the reductions live inside the dist-op VJPs")
    if mode == "gspmd" and compress_axis is None:
        from repro_torch.dist.collectives import world_size
        if world_size() > 1:
            raise NotImplementedError(GSPMD_LATER)
    if compress_axis is not None and compress_mesh is None:
        raise ValueError("compress_axis needs the DeviceMesh that names it "
                         "(compress_mesh=)")

    def train_step(state: TrainState, batch: Dict
                   ) -> Tuple[TrainState, Dict]:
        if n_microbatches > 1:
            grads, loss = None, 0.0
            for i in range(n_microbatches):
                mb = {k: v.chunk(n_microbatches)[i] for k, v in batch.items()}
                l_i, g_i = _value_and_grad(loss_fn, state.params, mb)
                g_i = pytree.tree_map(lambda g: g.float(), g_i)
                grads = g_i if grads is None else pytree.tree_map(
                    torch.add, grads, g_i)
                loss = loss + l_i
            grads = pytree.tree_map(lambda g: g / n_microbatches, grads)
            loss = loss / n_microbatches
        else:
            loss, grads = _value_and_grad(loss_fn, state.params, batch)
        err = state.err
        if compress_axis is not None:
            from repro_torch.dist.compress import compressed_psum_tree
            grads, err = compressed_psum_tree(grads, compress_mesh,
                                              compress_axis, err)
        params, opt = optimizer.update(grads, state.opt, state.params)
        metrics = {"loss": loss.float(), "grad_norm": global_norm(grads),
                   "step": opt.step}
        return TrainState(params=params, opt=opt, err=err), metrics

    return train_step


def init_train_state(params, optimizer: AdamW, *,
                     compress: bool = False) -> TrainState:
    err = (pytree.tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device), params)
        if compress else None)
    return TrainState(params=params, opt=optimizer.init(params), err=err)

"""Train-step assembly -- the port of ``repro/train/step.py``: gradients
of a loss, microbatch accumulation and the optimizer update.

``make_train_step(loss_fn, optimizer)`` returns ``train_step(state,
batch) -> (state, metrics)``, a function of its inputs (the state is not
updated in place).  It serves the JAX package's ``"dense"`` and
``"dist-grid"`` modes alike: on a grid the loss runs through the
``dist`` ops (``dist.train.make_grid_train_step``), whose backward
passes and glue already leave the complete gradient of every parameter
on every rank, so the step adds no collective and every rank runs the
same AdamW update on the same full parameters.

The JAX package's ``"gspmd"`` mode and int8 gradient compression wait
for the port of ``dist/compress.py``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.train.optim import AdamW, AdamWState, global_norm


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def _value_and_grad(loss_fn, params, batch):
    leaves, spec = pytree.tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss = loss_fn(pytree.tree_unflatten(leaves, spec), batch)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), pytree.tree_unflatten(list(grads), spec)


def make_train_step(loss_fn: Callable, optimizer: AdamW, *,
                    n_microbatches: int = 1) -> Callable:
    """``loss_fn(params, batch) -> scalar``; batch leaves are
    ``[global_batch, ...]`` and split into ``n_microbatches`` along dim
    0, whose gradients are averaged before the update."""
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
        params, opt = optimizer.update(grads, state.opt, state.params)
        metrics = {"loss": loss.float(), "grad_norm": global_norm(grads),
                   "step": opt.step}
        return TrainState(params=params, opt=opt), metrics

    return train_step


def init_train_state(params, optimizer: AdamW) -> TrainState:
    return TrainState(params=params, opt=optimizer.init(params))

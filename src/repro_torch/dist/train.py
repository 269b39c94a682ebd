"""Grid-parallel CNN training -- the port of ``repro/dist/train.py``
(the train step and its analytic accounting; the resilient loop waits
for the fault-runtime slice).

The step built here runs the loss, its gradients and the AdamW update
with every conv and the classifier head on the explicit-grid ``dist``
ops, whose backward passes transpose the forward schedule on the same
``(Pb, Ph, Pw, Pk, Pc)`` grid.  It is per-rank code: every rank passes
the same global batch and full parameters, and every rank ends the step
with the same updated parameters.

``cnn_train_comm_elems`` walks the layer structure of
``models.cnn.forward_cnn`` and sums the analytic per-rank fwd+bwd wire of
the dist *ops*; the inter-layer reshards (tag ``"reshard"``) come on
top.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Tuple

from torch.distributed.device_mesh import DeviceMesh

from repro_torch.dist.conv2d import (SAVE_GATHERED_LATER, conv_grid_divides,
                                     conv_train_comm_elems,
                                     conv_train_mem_elems)
from repro_torch.dist.matmul import (matmul_grid_divides,
                                     matmul_train_comm_elems,
                                     matmul_train_mem_elems)
from repro_torch.models.cnn import loss_cnn
from repro_torch.train.optim import AdamW
from repro_torch.train.step import TrainState, init_train_state, \
    make_train_step


def make_grid_train_step(optimizer: AdamW, mesh: DeviceMesh, *,
                         schedule: str = "allgather",
                         save_gathered: bool = False,
                         pool_every: int = 2,
                         n_microbatches: int = 1) -> Callable:
    """Train step (``(state, batch) -> (state, metrics)``) for the CNN on
    a 5-axis conv mesh, per rank.

    ``schedule`` picks the dist-op schedule (``allgather`` / ``ring`` /
    ``ring2``); the loss is ``models.cnn.loss_cnn``.
    ``save_gathered=True`` is a later slice."""
    if save_gathered:
        raise NotImplementedError(SAVE_GATHERED_LATER)
    loss = functools.partial(loss_cnn, pool_every=pool_every,
                             dist_mesh=mesh, dist_schedule=schedule,
                             dist_save_gathered=save_gathered)
    return make_train_step(loss, optimizer, n_microbatches=n_microbatches)


def init_grid_train_state(params, optimizer: AdamW) -> TrainState:
    """Train state for the grid-parallel step."""
    return init_train_state(params, optimizer)


def _cnn_layer_shapes(x_shape, channels: List[int], *, k: int,
                      pool_every: int) -> List[Tuple[tuple, tuple]]:
    """(x_shape, w_shape) per conv layer, mirroring ``forward_cnn``."""
    N, C, H, W = x_shape
    out = []
    cin = C
    for i, cout in enumerate(channels):
        out.append(((N, cin, H, W), (cout, cin, k, k)))
        cin = cout
        if (i + 1) % pool_every == 0:
            H, W = H // 2, W // 2
    return out


def cnn_train_comm_elems(x_shape, channels: List[int], n_classes: int,
                         grid, *, k: int = 3, pool_every: int = 2,
                         schedule: str = "allgather",
                         save_gathered: bool = False) -> Dict:
    """Analytic per-rank fwd+bwd wire (elements) of the dist ops in one
    CNN train step on ``grid = (Pb, Ph, Pw, Pk, Pc)``: one entry per conv
    layer plus the head matmul (0 when its shapes don't divide the
    matmul view and it runs dense)."""
    if len(grid) != 5:
        raise ValueError(f"conv grid must be (Pb,Ph,Pw,Pk,Pc), got {grid}")
    layers = [conv_train_comm_elems(xs, ws, grid, schedule=schedule,
                                    save_gathered=save_gathered)
              for xs, ws in _cnn_layer_shapes(x_shape, channels, k=k,
                                              pool_every=pool_every)]
    pb, ph, pw, pk, pc = grid
    mm_grid = (pb * ph * pw, pk, pc)
    N, cin = x_shape[0], channels[-1]
    if matmul_grid_divides(N, cin, n_classes, mm_grid):
        head = matmul_train_comm_elems(N, cin, n_classes, mm_grid,
                                       save_gathered=save_gathered)
    else:
        head = {"fwd": {"total": 0.0}, "bwd": {"total": 0.0}, "total": 0.0}
    total = sum(l["total"] for l in layers) + head["total"]
    return {"layers": layers, "head": head, "total": total,
            "fwd_total": sum(l["fwd"]["total"] for l in layers)
            + head["fwd"]["total"],
            "bwd_total": sum(l["bwd"]["total"] for l in layers)
            + head["bwd"]["total"]}


def cnn_train_mem_elems(x_shape, channels: List[int], n_classes: int,
                        grid, *, k: int = 3, pool_every: int = 2,
                        schedule: str = "allgather",
                        save_gathered: bool = False) -> Dict:
    """Analytic per-rank peak live memory (elements) of the dist ops in
    one CNN train step: the per-layer peaks and their max (layers run one
    after another)."""
    if len(grid) != 5:
        raise ValueError(f"conv grid must be (Pb,Ph,Pw,Pk,Pc), got {grid}")
    layers = [conv_train_mem_elems(xs, ws, grid, schedule=schedule,
                                   save_gathered=save_gathered)
              for xs, ws in _cnn_layer_shapes(x_shape, channels, k=k,
                                              pool_every=pool_every)]
    pb, ph, pw, pk, pc = grid
    mm_grid = (pb * ph * pw, pk, pc)
    N, cin = x_shape[0], channels[-1]
    if matmul_grid_divides(N, cin, n_classes, mm_grid):
        head = matmul_train_mem_elems(N, cin, n_classes, mm_grid,
                                      schedule=schedule,
                                      save_gathered=save_gathered)
    else:
        head = {"peak": 0.0}
    peak = max([l["peak"] for l in layers] + [head["peak"]])
    return {"layers": layers, "head": head, "peak": peak}


def grid_divides_cnn(x_shape, channels: List[int], grid, *, k: int = 3,
                     pool_every: int = 2) -> bool:
    """True when every conv layer of the CNN satisfies the divisibility
    constraints of ``conv2d_distributed`` on ``grid``."""
    return all(conv_grid_divides(xs, ws, grid)
               for xs, ws in _cnn_layer_shapes(x_shape, channels, k=k,
                                               pool_every=pool_every))

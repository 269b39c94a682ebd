"""CNN image model -- the port of ``repro/models/cnn.py``.

A ResNet-style stack of 3x3 SAME convs with bias, relu and a 2x2 max-pool
after every ``pool_every`` convs, then a spatial mean and a linear
classifier head.  Two execution paths share one parameter dict
(``{"convs": [{"w", "b"}], "head"}``, conv weights OIHW, head
``[cin, n_classes]``):

* the dense path through ``kernels.ops.conv2d_same`` (the direct-conv
  kernel with ``use_pallas=True``, ``F.conv2d`` otherwise);
* the **dist-grid** path (``dist_mesh=...``, per rank): every conv routes
  through ``dist.conv2d.conv2d_distributed`` on the 5-axis
  ``(Pb,Ph,Pw,Pk,Pc)`` mesh and the classifier head through
  ``dist.matmul.matmul_distributed`` on the ``(Pb*Ph*Pw, Pk, Pc)`` view of
  the same ranks.

In the JAX package the glue between the ops runs on global arrays and
the compiler inserts the reshards.  Here the glue runs on shards and the
reshards are explicit collectives, recorded under the tag ``"reshard"``:
the conv output (``OUT_SPEC``, replicated over c) is regathered over k
and sliced into the next conv's ``IN_SPEC`` when ``Pc > 1``; the spatial
mean is summed over the h and w axes; the head input is cut into the
matmul's ``X_SPEC``; the logits are gathered onto every rank.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.dist.collectives import mesh_grid, psum, shard, unshard
from repro_torch.dist.conv2d import (AXES, IN_SPEC, KER_SPEC,
                                     SAVE_GATHERED_LATER, conv2d_distributed)
from repro_torch.dist.matmul import (OUT_SPEC as MM_OUT_SPEC, W_SPEC,
                                     matmul_distributed, matmul_grid_divides,
                                     matmul_mesh_from_conv)
from repro_torch.kernels.ops import conv2d_same


def init_cnn(generator: torch.Generator, *, channels: List[int],
             n_classes: int, in_channels: int = 3, k: int = 3,
             device=None) -> Dict:
    """Random parameters drawn from ``generator`` (a CPU generator, so the
    same seed gives the same weights on every device), scaled like the
    JAX package's ``init_cnn``; biases start at zero."""
    device = resolve_device(device)

    def normal(shape, scale):
        t = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (t * scale).to(device)

    convs = []
    cin = in_channels
    for cout in channels:
        convs.append({"w": normal((cout, cin, k, k), (cin * k * k) ** -0.5),
                      "b": torch.zeros((cout,), device=device)})
        cin = cout
    return {"convs": convs, "head": normal((cin, n_classes), cin ** -0.5)}


def _bias_relu(y, b):
    return F.relu(y + b[None, :, None, None])


def _pool_local(y, ph: int, pw: int):
    """2x2/2 max-pool of a spatial shard; refuses a shard whose windows
    would straddle the boundary to the next rank."""
    if (ph > 1 and y.shape[2] % 2) or (pw > 1 and y.shape[3] % 2):
        raise ValueError(
            f"2x2 pool windows would cross a spatial shard: local extent "
            f"{tuple(y.shape[2:])} on (Ph, Pw) = ({ph}, {pw})")
    return F.max_pool2d(y, 2, 2)


def _features_to_channel_shards(y, mesh, pk: int, pc: int):
    """Out-layout channels (block k of Pk, replicated over c) to block
    ``c * Pk + k`` of ``Pc * Pk``, along dim 1."""
    if pc == 1:
        return y
    rest = (None,) * (y.dim() - 2)
    full = unshard(y, mesh, (None, "k") + rest) if pk > 1 else y
    return shard(full, mesh, (None, ("c", "k")) + rest)


def _forward_dist(params, x, mesh, *, pool_every, schedule):
    pb, ph, pw, pk, pc = mesh_grid(mesh, AXES)
    n_img, _, h, w = x.shape
    xl = shard(x, mesh, IN_SPEC)
    for i, blk in enumerate(params["convs"]):
        if i:
            xl = _features_to_channel_shards(y, mesh, pk, pc)
        y = conv2d_distributed(xl, shard(blk["w"], mesh, KER_SPEC), mesh,
                               schedule=schedule)
        y = _bias_relu(y, shard(blk["b"], mesh, ("k",),
                                grad_psum_axes=("b", "h", "w")))
        if (i + 1) % pool_every == 0:
            y = _pool_local(y, ph, pw)
            h, w = h // 2, w // 2
    # spatial mean: local sums, then summed over the spatial axes
    feat = y.sum(dim=(2, 3)) / (h * w)
    for axis, p in (("h", ph), ("w", pw)):
        if p > 1:
            feat = psum(feat, mesh, axis, tag="reshard")
    head = params["head"]
    mm_mesh = matmul_mesh_from_conv(mesh)
    if not matmul_grid_divides(n_img, head.shape[0], head.shape[1],
                               (pb * ph * pw, pk, pc)):
        full = unshard(feat, mesh, ("b", "k"))
        return torch.matmul(full.float(), head.float()).to(feat.dtype)
    # rows: this b-block's sub-block h*Pw + w is matmul row block m
    xm = _features_to_channel_shards(
        shard(feat, mesh, (("h", "w"), None)), mesh, pk, pc)
    out = matmul_distributed(xm, shard(head, mm_mesh, W_SPEC), mm_mesh,
                             schedule=schedule)
    return unshard(out, mm_mesh, MM_OUT_SPEC)


def forward_cnn(params: Dict, x: torch.Tensor, *, pool_every: int = 2,
                use_pallas: bool = False, dist_mesh=None,
                dist_schedule: str = "allgather",
                dist_save_gathered: bool = False) -> torch.Tensor:
    """x: [N, C, H, W] -> logits [N, n_classes], on ``x``'s device.

    ``dist_mesh``: a 5-axis conv mesh (``dist.conv2d.make_conv_mesh``);
    then every rank passes the same global ``x`` and parameters, computes
    on its shards, and gets the global logits back (and, under autograd,
    the full parameter gradients).  ``dist_schedule`` picks the op
    schedule (``allgather`` / ``ring`` / ``ring2``);
    ``dist_save_gathered=True`` is a later slice."""
    if dist_save_gathered:
        raise NotImplementedError(SAVE_GATHERED_LATER)
    if dist_mesh is not None:
        return _forward_dist(params, x, dist_mesh, pool_every=pool_every,
                             schedule=dist_schedule)
    for i, blk in enumerate(params["convs"]):
        x = _bias_relu(conv2d_same(x, blk["w"], use_pallas=use_pallas),
                       blk["b"])
        if (i + 1) % pool_every == 0:
            x = F.max_pool2d(x, 2, 2)
    x = x.mean(dim=(2, 3))
    return torch.matmul(x.float(), params["head"].float()).to(x.dtype)


def loss_cnn(params: Dict, batch: Dict, **kw) -> torch.Tensor:
    """Mean cross-entropy of ``batch["images"]`` against
    ``batch["labels"]``."""
    logits = forward_cnn(params, batch["images"], **kw)
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, batch["labels"][:, None]).mean()


class CNN(nn.Module):
    """``forward_cnn`` as a module over the parameter dict's tensors."""

    def __init__(self, params: Dict, *, pool_every: int = 2,
                 use_pallas: bool = False):
        super().__init__()
        self.convs = nn.ParameterList()
        for blk in params["convs"]:
            self.convs.append(nn.Parameter(blk["w"]))
            self.convs.append(nn.Parameter(blk["b"]))
        self.head = nn.Parameter(params["head"])
        self.pool_every = pool_every
        self.use_pallas = use_pallas

    def params(self) -> Dict:
        it = iter(self.convs)
        return {"convs": [{"w": w, "b": b} for w, b in zip(it, it)],
                "head": self.head}

    def forward(self, x: torch.Tensor, *, dist_mesh=None,
                dist_schedule: str = "allgather") -> torch.Tensor:
        return forward_cnn(self.params(), x, pool_every=self.pool_every,
                           use_pallas=self.use_pallas, dist_mesh=dist_mesh,
                           dist_schedule=dist_schedule)

"""AdamW with f32 state, global-norm clipping and a cosine schedule -- the
port of ``repro/train/optim.py`` (AdamW and its helpers; SGD-momentum is
not on the port's path).

Parameters, gradients and state are pytrees of tensors (nested dicts and
lists, as ``models.cnn`` builds them).  The update is functional, like
the JAX package's: it returns new parameters and a new state and leaves
its inputs untouched.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Tuple, Union

import torch
from torch.utils import _pytree as pytree


class AdamWState(NamedTuple):
    step: int
    m: object
    v: object


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[Callable[[int], float], float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params) -> AdamWState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return AdamWState(step=0, m=pytree.tree_map(zeros, params),
                          v=pytree.tree_map(zeros, params))

    def _lr(self, step: int) -> float:
        return float(self.lr(step)) if callable(self.lr) else float(self.lr)

    def update(self, grads, state: AdamWState, params
               ) -> Tuple[object, AdamWState]:
        step = state.step + 1
        gnorm = global_norm(grads)
        scale = torch.clamp(self.clip_norm / (gnorm + 1e-12), max=1.0)
        bc1 = 1 - self.b1 ** step
        bc2 = 1 - self.b2 ** step
        lr = self._lr(step)

        def upd(g, m, v, p):
            g = g.float() * scale
            m2 = self.b1 * m + (1 - self.b1) * g
            v2 = self.b2 * v + (1 - self.b2) * g * g
            delta = (m2 / bc1) / (torch.sqrt(v2 / bc2) + self.eps) \
                + self.weight_decay * p.float()
            return (p.float() - lr * delta).to(p.dtype), m2, v2

        flat_p, spec = pytree.tree_flatten(params)
        flat_g = pytree.tree_leaves(grads)
        flat_m = pytree.tree_leaves(state.m)
        flat_v = pytree.tree_leaves(state.v)
        out = [upd(g, m, v, p) for g, m, v, p
               in zip(flat_g, flat_m, flat_v, flat_p)]
        new_p, new_m, new_v = (pytree.tree_unflatten([o[i] for o in out],
                                                     spec)
                               for i in range(3))
        return new_p, AdamWState(step=step, m=new_m, v=new_v)


def global_norm(tree) -> torch.Tensor:
    """Euclidean norm of every leaf together, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in pytree.tree_leaves(tree)))


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1) -> Callable[[int], float]:
    """Linear warm-up to ``base_lr``, then a cosine down to
    ``min_ratio * base_lr`` at ``total``."""
    def lr(step: int) -> float:
        if step < warmup:
            return base_lr * step / max(warmup, 1)
        prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return base_lr * (min_ratio + (1 - min_ratio) * 0.5
                          * (1 + math.cos(math.pi * prog)))
    return lr

"""Parameters from the JAX package's CNN into the port.

Both packages keep conv weights OIHW and the head ``[cin, n_classes]``,
so the conversion is a copy with shape checks.  It is the one way the
tests hand the same weights to both packages.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.device import resolve_device


def params_from_jax(params_np: Dict, *, device=None) -> Dict:
    """``{"convs": [{"w", "b"}], "head"}`` of array-likes (the JAX
    parameter pytree passed through ``np.asarray``) -> the same dict of
    float32 tensors on ``device`` (``cuda`` by default)."""
    device = resolve_device(device)

    def tensor(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=device)

    convs, cin = [], None
    for i, blk in enumerate(params_np["convs"]):
        w, b = tensor(blk["w"]), tensor(blk["b"])
        if w.dim() != 4 or b.shape != (w.shape[0],):
            raise ValueError(f"conv {i}: want w [K,C,kh,kw] and b [K], got "
                             f"{tuple(w.shape)} and {tuple(b.shape)}")
        if cin is not None and w.shape[1] != cin:
            raise ValueError(f"conv {i} takes {w.shape[1]} channels, the "
                             f"previous conv gives {cin}")
        convs.append({"w": w, "b": b})
        cin = w.shape[0]
    head = tensor(params_np["head"])
    if head.dim() != 2 or (cin is not None and head.shape[0] != cin):
        raise ValueError(f"head must be [{cin}, n_classes], got "
                         f"{tuple(head.shape)}")
    return {"convs": convs, "head": head}

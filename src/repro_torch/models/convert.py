"""Parameters from the JAX package's models into the port: the CNN
(:func:`params_from_jax`) and the decoder LM (:func:`lm_params_from_jax`).

Both packages keep conv weights OIHW, the head ``[cin, n_classes]`` and
every LM projection ``[in, out]``, so the conversion is a copy with shape
checks (the LM's stacked layers are unstacked).  It is the one way the
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


def _lm_block_shapes(cfg) -> Dict:
    d, hd = cfg.d_model, cfg.head_dim
    blk = {"ln1": (d,), "ln2": (d,),
           "attn": {"wq": (d, cfg.n_heads * hd),
                    "wk": (d, cfg.n_kv_heads * hd),
                    "wv": (d, cfg.n_kv_heads * hd),
                    "wo": (cfg.n_heads * hd, d)}}
    if cfg.is_moe:
        e, f = cfg.n_experts, cfg.d_ff
        blk["moe"] = {"router": (d, e), "w_gate": (e, d, f),
                      "w_up": (e, d, f), "w_down": (e, f, d)}
    else:
        blk["mlp"] = {"w_up": (d, cfg.d_ff), "w_down": (cfg.d_ff, d)}
        if cfg.mlp_act in ("swiglu", "geglu"):
            blk["mlp"]["w_gate"] = (d, cfg.d_ff)
    return blk


def lm_params_from_jax(params_np: Dict, cfg, *, device=None) -> Dict:
    """The JAX package's ``init_lm`` pytree (arrays through
    ``np.asarray``) -> the port's LM parameters on ``device`` (``cuda`` by
    default): the scanned ``blocks`` (every leaf stacked on a leading
    ``n_layers`` axis) unstacked into one dict per layer, each tensor in
    ``cfg``'s dtype (the router stays float32, as in the reference), and
    every shape checked against ``cfg``."""
    device = resolve_device(device)
    n = cfg.n_layers

    def tensor(a, shape, where, dtype):
        a = np.asarray(a, dtype=np.float32)
        if a.shape != tuple(shape):
            raise ValueError(f"{where}: want shape {tuple(shape)} for "
                             f"{cfg.arch_id}, got {a.shape}")
        return torch.from_numpy(a.copy()).to(device=device, dtype=dtype)

    def convert(tree, shapes, where, layer=None):
        if set(tree) != set(shapes):
            raise ValueError(f"{where}: want keys {sorted(shapes)}, got "
                             f"{sorted(tree)}")
        out = {}
        for key, shape in shapes.items():
            name = f"{where}.{key}"
            if isinstance(shape, dict):
                out[key] = convert(tree[key], shape, name, layer)
                continue
            a = np.asarray(tree[key])
            if layer is not None:
                if a.shape[:1] != (n,):
                    raise ValueError(f"{name}: want {n} stacked layers, "
                                     f"got shape {a.shape}")
                a = a[layer]
            dtype = torch.float32 if key == "router" else cfg.torch_dtype
            out[key] = tensor(a, shape, name, dtype)
        return out

    shapes = _lm_block_shapes(cfg)
    return {
        "emb": convert(params_np["emb"],
                       {"tok": (cfg.vocab, cfg.d_model),
                        "lm_head": (cfg.d_model, cfg.vocab)}, "emb"),
        "blocks": [convert(params_np["blocks"], shapes, f"blocks[{i}]", i)
                   for i in range(n)],
        "ln_f": tensor(params_np["ln_f"], (cfg.d_model,), "ln_f",
                       cfg.torch_dtype),
    }

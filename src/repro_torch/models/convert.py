"""Parameters from the JAX package's models into the port: the CNN
(:func:`params_from_jax`), the decoder LM (:func:`lm_params_from_jax`)
and the zoo (:func:`ssm_lm_params_from_jax`,
:func:`hybrid_params_from_jax`, :func:`encdec_params_from_jax`).

Both packages keep conv weights OIHW, the head ``[cin, n_classes]`` and
every projection ``[in, out]``, so the conversion is a copy with key and
shape checks (the reference's stacked layers are unstacked).  It is the
one way the tests hand the same weights to both packages.
"""

from __future__ import annotations

import dataclasses
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


# leaves the reference keeps in float32 whatever the config's dtype
_F32_KEYS = frozenset({"router", "A_log", "D", "dt_bias", "gates", "bias"})


def _tensor(a, shape, where: str, cfg, dtype, device) -> torch.Tensor:
    a = np.asarray(a, dtype=np.float32)
    if a.shape != tuple(shape):
        raise ValueError(f"{where}: want shape {tuple(shape)} for "
                         f"{cfg.arch_id}, got {a.shape}")
    return torch.from_numpy(a.copy()).to(device=device, dtype=dtype)


def _convert(tree, shapes: Dict, where: str, cfg, device,
             layer=None, n_stacked=None) -> Dict:
    """``tree`` (a dict of array-likes) -> the same dict of tensors, keys
    and shapes checked against ``shapes``; with ``layer``, every leaf is
    stacked on a leading ``n_stacked`` axis and its ``layer``-th entry is
    taken.  Each tensor takes ``cfg``'s dtype, the keys of
    :data:`_F32_KEYS` float32."""
    if set(tree) != set(shapes):
        raise ValueError(f"{where}: want keys {sorted(shapes)}, got "
                         f"{sorted(tree)}")
    out = {}
    for key, shape in shapes.items():
        name = f"{where}.{key}"
        if isinstance(shape, dict):
            out[key] = _convert(tree[key], shape, name, cfg, device, layer,
                                n_stacked)
            continue
        a = np.asarray(tree[key])
        if layer is not None:
            if a.shape[:1] != (n_stacked,):
                raise ValueError(f"{name}: want {n_stacked} stacked layers, "
                                 f"got shape {a.shape}")
            a = a[layer]
        dtype = torch.float32 if key in _F32_KEYS else cfg.torch_dtype
        out[key] = _tensor(a, shape, name, cfg, dtype, device)
    return out


def _unstack(params_np: Dict, key: str, shapes: Dict, n: int, cfg,
             device) -> list:
    """The reference's ``jax.vmap``-stacked blocks ``params_np[key]`` as
    one dict per layer."""
    return [_convert(params_np[key], shapes, f"{key}[{i}]", cfg, device,
                     i, n) for i in range(n)]


def _emb_shapes(cfg) -> Dict:
    return {"tok": (cfg.vocab, cfg.d_model),
            "lm_head": (cfg.d_model, cfg.vocab)}


def _checked_keys(params_np: Dict, want) -> None:
    if set(params_np) != set(want):
        raise ValueError(f"params: want keys {sorted(want)}, got "
                         f"{sorted(params_np)}")


def lm_params_from_jax(params_np: Dict, cfg, *, device=None) -> Dict:
    """The JAX package's ``init_lm`` pytree (arrays through
    ``np.asarray``) -> the port's LM parameters on ``device`` (``cuda`` by
    default): the scanned ``blocks`` (every leaf stacked on a leading
    ``n_layers`` axis) unstacked into one dict per layer, each tensor in
    ``cfg``'s dtype (the router stays float32, as in the reference), and
    every shape checked against ``cfg``."""
    device = resolve_device(device)
    return {
        "emb": _convert(params_np["emb"], _emb_shapes(cfg), "emb", cfg,
                        device),
        "blocks": _unstack(params_np, "blocks", _lm_block_shapes(cfg),
                           cfg.n_layers, cfg, device),
        "ln_f": _tensor(params_np["ln_f"], (cfg.d_model,), "ln_f", cfg,
                        cfg.torch_dtype, device),
    }


def ssm_lm_params_from_jax(params_np: Dict, cfg, *, device=None) -> Dict:
    """The reference's ``init_ssm_lm`` pytree -> the port's xLSTM LM on
    ``device``: ``mblocks`` and ``sblocks`` unstacked, the mLSTM
    ``gates`` and the sLSTM ``bias`` float32, every key and shape checked
    against ``cfg``."""
    device = resolve_device(device)
    d = cfg.d_model
    di = cfg.ssm_expand * d
    h = cfg.n_heads
    hd = d // h
    n_s = cfg.n_layers // cfg.slstm_every if cfg.slstm_every else 0
    _checked_keys(params_np, {"emb", "mblocks", "ln_f"}
                  | ({"sblocks"} if n_s else set()))
    mlstm = {"w_x": (d, di), "w_z": (d, di), "wq": (di, di),
             "wk": (di, di), "wv": (di, di), "gates": (di, 2 * h),
             "out_proj": (di, d), "norm_w": (di,)}
    out = {
        "emb": _convert(params_np["emb"], _emb_shapes(cfg), "emb", cfg,
                        device),
        "mblocks": _unstack(params_np, "mblocks",
                            {"ln": (d,), "mlstm": mlstm}, cfg.n_layers - n_s,
                            cfg, device),
        "ln_f": _tensor(params_np["ln_f"], (d,), "ln_f", cfg,
                        cfg.torch_dtype, device),
    }
    if n_s:
        slstm = {"w_in": (d, 4 * d), "r": (h, hd, 4 * hd),
                 "bias": (4 * d,), "out_proj": (d, d)}
        out["sblocks"] = _unstack(params_np, "sblocks",
                                  {"ln": (d,), "slstm": slstm}, n_s, cfg,
                                  device)
    return out


def hybrid_params_from_jax(params_np: Dict, cfg, *, device=None) -> Dict:
    """The reference's ``init_hybrid`` pytree -> the port's Zamba2 LM on
    ``device``: ``mblocks`` unstacked, the ``shared`` block one dict,
    ``A_log``, ``D`` and ``dt_bias`` float32, every key and shape checked
    against ``cfg``."""
    device = resolve_device(device)
    d, n = cfg.d_model, cfg.ssm_state
    di = cfg.ssm_expand * d
    nh = di // cfg.head_dim
    _checked_keys(params_np, {"emb", "mblocks", "shared", "ln_f"})
    mamba = {"w_z": (d, di), "w_x": (d, di), "w_B": (d, n), "w_C": (d, n),
             "w_dt": (d, nh), "out_proj": (di, d), "conv_x": (4, di),
             "conv_B": (4, n), "conv_C": (4, n), "A_log": (nh,),
             "D": (nh,), "dt_bias": (nh,), "norm_w": (di,)}
    return {
        "emb": _convert(params_np["emb"], _emb_shapes(cfg), "emb", cfg,
                        device),
        "mblocks": _unstack(params_np, "mblocks",
                            {"ln": (d,), "mamba": mamba}, cfg.n_layers, cfg,
                            device),
        "shared": _convert(params_np["shared"], _lm_block_shapes(cfg),
                           "shared", cfg, device),
        "ln_f": _tensor(params_np["ln_f"], (d,), "ln_f", cfg,
                        cfg.torch_dtype, device),
    }


def encdec_params_from_jax(params_np: Dict, cfg, *, device=None) -> Dict:
    """The reference's ``init_encdec`` pytree -> the port's Whisper
    backbone on ``device``: ``enc`` and ``dec`` unstacked, every key and
    shape checked against ``cfg``."""
    device = resolve_device(device)
    d = cfg.d_model
    _checked_keys(params_np, {"emb", "enc", "dec", "ln_enc", "ln_f"})
    enc = dataclasses.replace(cfg, mlp_act="gelu", n_experts=0)
    block = _lm_block_shapes(enc)
    dec = dict(block, ln3=(d,), xattn=block["attn"])
    return {
        "emb": _convert(params_np["emb"], _emb_shapes(cfg), "emb", cfg,
                        device),
        "enc": _unstack(params_np, "enc", block, cfg.n_enc_layers, cfg,
                        device),
        "dec": _unstack(params_np, "dec", dec, cfg.n_layers, cfg, device),
        **{key: _tensor(params_np[key], (d,), key, cfg, cfg.torch_dtype,
                        device) for key in ("ln_enc", "ln_f")},
    }

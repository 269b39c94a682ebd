"""Unified model configuration for all assigned architectures -- the port
of ``repro/models/config.py``.

Pure Python: the dtype is a string, and :attr:`ModelConfig.torch_dtype`
imports torch only when it is read, so the configs import without torch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str              # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: Optional[int] = None   # default: d_model // n_heads
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    mlp_act: str = "swiglu"          # swiglu | geglu | gelu
    dtype: str = "bfloat16"

    # local/global attention (gemma3): period p means layers with
    # (i % p != p-1) use sliding-window attention.
    attn_pattern_period: int = 0     # 0 = all global
    sliding_window: int = 1024

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 1024   # dispatch-einsum cost is linear in this

    # SSM / hybrid
    ssm_state: int = 0               # Mamba2 state size
    ssm_expand: int = 2
    ssm_chunk: int = 256
    attn_every: int = 0              # zamba2: shared attn block period
    slstm_every: int = 0             # xlstm: sLSTM block period

    # enc-dec
    n_enc_layers: int = 0            # whisper encoder depth

    # VLM
    mrope_sections: Tuple[int, int, int] = (0, 0, 0)  # qwen2-vl t/h/w split

    # training-time
    remat: bool = True
    fsdp: bool = False               # additionally shard params over data axis
    tie_embeddings: bool = False     # kept False; see DESIGN.md §6

    max_seq: int = 8192              # serve-time cache allocation default

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def torch_dtype(self):
        """``dtype`` as a ``torch.dtype`` (the reference's ``jdtype``)."""
        import torch
        return getattr(torch, self.dtype)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> int:
        """Analytic parameter count (matches init; used for MODEL_FLOPS)."""
        d, hd = self.d_model, self.head_dim
        attn = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads \
            + hd * self.n_heads * d
        if self.is_moe:
            mlp = self.n_experts * (3 * d * self.d_ff) + d * self.n_experts
        elif self.d_ff > 0:
            mult = 3 if self.mlp_act in ("swiglu", "geglu") else 2
            mlp = mult * d * self.d_ff
        else:
            mlp = 0
        norms = 2 * d

        if self.family == "ssm":
            per_mlstm = self._mlstm_params()
            per_slstm = self._slstm_params()
            n_s = self.n_layers // self.slstm_every if self.slstm_every else 0
            blocks = per_mlstm * (self.n_layers - n_s) + per_slstm * n_s \
                + self.n_layers * d
        elif self.family == "hybrid":
            per_mamba = self._mamba_params()
            shared = attn + mlp + norms  # one shared block
            blocks = per_mamba * self.n_layers + self.n_layers * d + shared
        elif self.family == "encdec":
            # decoder layers have an extra cross-attention block
            blocks = self.n_layers * (2 * attn + mlp + 3 * d) \
                + self.n_enc_layers * (attn + mlp + norms)
        else:
            blocks = self.n_layers * (attn + mlp + norms)

        emb = self.vocab * d * 2  # untied in + out
        return blocks + emb + d   # + final norm

    def active_param_count(self) -> int:
        """MoE: params touched per token (for 6*N_active*D)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        hd = self.head_dim
        attn = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads \
            + hd * self.n_heads * d
        mlp_active = self.top_k * (3 * d * self.d_ff) + d * self.n_experts
        blocks = self.n_layers * (attn + mlp_active + 2 * d)
        return blocks + self.vocab * d * 2 + d

    def _mamba_params(self) -> int:
        d = self.d_model
        di = self.ssm_expand * d
        # in_proj (z, x, B, C, dt) + out_proj + conv + A/D/dt_bias
        heads = di // max(self.head_dim, 1)
        return (d * (2 * di + 2 * self.ssm_state + heads)
                + di * d + 4 * di + 3 * heads)

    def _mlstm_params(self) -> int:
        d = self.d_model
        di = self.ssm_expand * d
        return d * 2 * di + di * (3 * di // 4) + di * d + 2 * di

    def _slstm_params(self) -> int:
        d = self.d_model
        return 4 * d * d + 4 * d * d + 8 * d  # input + recurrent + biases

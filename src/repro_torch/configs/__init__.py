"""Architecture registry: one module per assigned architecture.

Each module defines ``config()`` (the exact published configuration) and
``smoke_config()`` (a reduced same-family variant for CPU tests).  The
port of ``repro/configs``: the same data, published widths unchanged.
The ``ssm``, ``hybrid`` and ``encdec`` configurations are data only here;
the port serves the transformer families (``launch.serve``).
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = [
    "llama3_2_1b",
    "smollm_360m",
    "gemma3_12b",
    "gemma3_4b",
    "zamba2_7b",
    "xlstm_350m",
    "whisper_tiny",
    "granite_moe_1b_a400m",
    "qwen3_moe_235b_a22b",
    "qwen2_vl_72b",
]

# canonical external names (with dashes/dots) -> module names
ALIASES: Dict[str, str] = {
    "llama3.2-1b": "llama3_2_1b",
    "smollm-360m": "smollm_360m",
    "gemma3-12b": "gemma3_12b",
    "gemma3-4b": "gemma3_4b",
    "zamba2-7b": "zamba2_7b",
    "xlstm-350m": "xlstm_350m",
    "whisper-tiny": "whisper_tiny",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "qwen2-vl-72b": "qwen2_vl_72b",
}


def get_config(arch: str, *, smoke: bool = False) -> ModelConfig:
    mod_name = ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.smoke_config() if smoke else mod.config()


def all_configs(smoke: bool = False) -> Dict[str, ModelConfig]:
    return {a: get_config(a, smoke=smoke) for a in ARCH_IDS}

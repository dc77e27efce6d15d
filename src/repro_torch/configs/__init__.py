"""Architecture registry of the port: ``get_config(name)`` /
``get_smoke(name)`` / ``ARCHS`` list all 10 assigned architectures.

The names are the reference's (``repro.configs``), dashed public ids
included; an unknown name raises ``KeyError``.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    SHAPES,
    ModelConfig,
    ShapeConfig,
    input_specs,
    reduced,
    shape_applicable,
)

ARCHS = [
    "olmo_1b",
    "command_r_35b",
    "gemma2_2b",
    "starcoder2_3b",
    "llava_next_34b",
    "rwkv6_1b6",
    "granite_moe_3b",
    "llama4_scout_17b",
    "whisper_base",
    "zamba2_2b7",
]

_ALIASES = {
    "olmo-1b": "olmo_1b",
    "command-r-35b": "command_r_35b",
    "gemma2-2b": "gemma2_2b",
    "starcoder2-3b": "starcoder2_3b",
    "llava-next-34b": "llava_next_34b",
    "rwkv6-1.6b": "rwkv6_1b6",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "llama4-scout-17b-a16e": "llama4_scout_17b",
    "whisper-base": "whisper_base",
    "zamba2-2.7b": "zamba2_2b7",
}


def _module(name: str):
    mod = _ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if mod not in ARCHS:
        raise KeyError(f"unknown architecture {name!r}; known: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE


__all__ = [
    "ARCHS",
    "SHAPES",
    "ModelConfig",
    "ShapeConfig",
    "get_config",
    "get_smoke",
    "input_specs",
    "reduced",
    "shape_applicable",
]

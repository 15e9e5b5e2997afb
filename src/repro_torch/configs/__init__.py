"""Assigned architecture registry: ``--arch <id>`` resolves here."""

from __future__ import annotations

from importlib import import_module
from typing import Dict

from .base import SHAPES, ArchConfig, ShapeConfig

ARCH_IDS = [
    "gemma3_12b", "deepseek_67b", "qwen2_7b", "internlm2_20b",
    "chameleon_34b", "llama4_maverick", "olmoe_1b_7b", "mamba2_370m",
    "zamba2_2_7b", "whisper_base",
]

_ALIASES = {
    "gemma3-12b": "gemma3_12b", "deepseek-67b": "deepseek_67b",
    "qwen2-7b": "qwen2_7b", "internlm2-20b": "internlm2_20b",
    "chameleon-34b": "chameleon_34b",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "olmoe-1b-7b": "olmoe_1b_7b", "mamba2-370m": "mamba2_370m",
    "zamba2-2.7b": "zamba2_2_7b", "whisper-base": "whisper_base",
}


def get_arch(name: str) -> ArchConfig:
    mod_name = _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    mod = import_module(f".{mod_name}", __package__)
    return mod.CONFIG


def all_archs() -> Dict[str, ArchConfig]:
    return {a: get_arch(a) for a in ARCH_IDS}


__all__ = ["ARCH_IDS", "SHAPES", "ArchConfig", "ShapeConfig", "all_archs",
           "get_arch"]

"""System configurations: the BSS-2 wafer module (``BSS2``) and the ten
language-model architectures of the JAX package, resolved by
``get(arch_id)`` (``repro.configs``)."""

from __future__ import annotations

import importlib

from repro_torch.configs import bss2 as _bss2
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig, runnable

_MODULES = {
    "llama4-maverick-400b-a17b":
        "repro_torch.configs.llama4_maverick_400b_a17b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b_a400m",
    "whisper-medium": "repro_torch.configs.whisper_medium",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2p7b",
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "yi-9b": "repro_torch.configs.yi_9b",
    "llama3-8b": "repro_torch.configs.llama3_8b",
    "internlm2-1.8b": "repro_torch.configs.internlm2_1p8b",
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
    "chameleon-34b": "repro_torch.configs.chameleon_34b",
}

ARCH_IDS = tuple(_MODULES)
BSS2 = _bss2.CONFIG


def get(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).CONFIG


def all_archs() -> dict[str, ArchConfig]:
    return {aid: get(aid) for aid in ARCH_IDS}


__all__ = [
    "ARCH_IDS", "BSS2", "SHAPES", "ArchConfig", "ShapeConfig", "all_archs",
    "get", "runnable",
]

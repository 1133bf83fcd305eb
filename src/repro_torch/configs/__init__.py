"""System configurations: the BSS-2 wafer module (``bss2``) and the
language-model architectures, resolved by ``get(arch_id)``."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

_MODULES = {
    "zamba2-2.7b": "repro_torch.configs.zamba2_2p7b",
    "internlm2-1.8b": "repro_torch.configs.internlm2_1p8b",
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b_a400m",
    "llama4-maverick-400b-a17b":
        "repro_torch.configs.llama4_maverick_400b_a17b",
    "whisper-medium": "repro_torch.configs.whisper_medium",
}
# Architectures of the JAX package not ported yet, and what brings each.
_LATER = {
    "mistral-nemo-12b": "the remaining dense configs",
    "yi-9b": "the remaining dense configs",
    "llama3-8b": "the remaining dense configs",
    "chameleon-34b": "the remaining dense configs",
}

ARCH_IDS = tuple(_MODULES)


def get(arch_id: str) -> ArchConfig:
    if arch_id in _LATER:
        raise NotImplementedError(
            f"{arch_id} is not ported yet; it comes with {_LATER[arch_id]} "
            f"of the LM stack (ROADMAP section 1, item 9)")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(_MODULES) + sorted(_LATER)}")
    return importlib.import_module(_MODULES[arch_id]).CONFIG


__all__ = ["ARCH_IDS", "ArchConfig", "get"]

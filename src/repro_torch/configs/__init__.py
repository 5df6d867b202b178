"""Architecture registry of the port: the dense archs ported so far."""
from __future__ import annotations

import importlib

from ..models.transformer import ModelConfig

ARCH_IDS = ["qwen2_1_5b"]


def normalize(arch: str) -> str:
    """'qwen2-1.5b' / 'qwen2-1-5b' / 'qwen2_1_5b' all resolve."""
    cand = arch.replace(".", "_").replace("-", "_")
    if cand in ARCH_IDS:
        return cand
    raise KeyError(f"unknown or unported arch {arch!r}; ported: {ARCH_IDS}")


def get_config(arch: str) -> ModelConfig:
    """The full configuration of ``arch``."""
    return importlib.import_module(f"{__name__}.{normalize(arch)}").CONFIG


def get_smoke(arch: str) -> ModelConfig:
    """The reduced same-family configuration of ``arch`` (CPU tests)."""
    return importlib.import_module(f"{__name__}.{normalize(arch)}").SMOKE

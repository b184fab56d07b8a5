"""Architecture registry, ported one config at a time.

``get(name)`` -> the full ArchConfig; ``reduced(name)`` -> the same family
at tiny dims (CPU tests).  Ported: ``deepseek-v2-lite-16b`` (moe),
``zamba2-7b`` (hybrid) and ``mamba2-780m`` (ssm); the other seven configs
of ``repro.configs`` are still to port (ROADMAP Queue 1 item 6) and raise
``NotImplementedError``.
"""
from __future__ import annotations

import importlib
from typing import List

ARCHS = ["deepseek-v2-lite-16b", "zamba2-7b", "mamba2-780m"]

_MODULES = {"deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
            "zamba2-7b": "zamba2_7b", "mamba2-780m": "mamba2_780m"}

_NOT_PORTED = [
    "nemotron-4-15b", "gemma3-1b", "qwen1.5-0.5b", "qwen2-0.5b",
    "qwen2-vl-2b", "mixtral-8x7b", "seamless-m4t-medium",
]


def _mod(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"config {name!r} is not ported yet (ROADMAP Queue 1 item 6)")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ARCHS}")
    return importlib.import_module(f".{_MODULES[name]}", __package__)


def get(name: str):
    return _mod(name).config()


def reduced(name: str):
    return _mod(name).reduced()


def list_archs() -> List[str]:
    return list(ARCHS)

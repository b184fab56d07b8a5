"""Architecture registry, ported one config at a time.

``get(name)`` -> the full ArchConfig; ``reduced(name)`` -> the same family
at tiny dims (CPU tests).  Ported: the dense ``qwen2-0.5b``,
``qwen1.5-0.5b``, ``gemma3-1b`` and ``nemotron-4-15b``, the vlm
``qwen2-vl-2b``, the moe ``deepseek-v2-lite-16b``, the hybrid
``zamba2-7b`` and the ssm ``mamba2-780m``; ``mixtral-8x7b`` (moe with GQA)
and ``seamless-m4t-medium`` (audio) are still to port (ROADMAP Queue 1)
and raise ``NotImplementedError``.
"""
from __future__ import annotations

import importlib
from typing import List

ARCHS = ["nemotron-4-15b", "gemma3-1b", "qwen1.5-0.5b", "qwen2-0.5b",
         "mamba2-780m", "qwen2-vl-2b", "deepseek-v2-lite-16b", "zamba2-7b"]

_MODULES = {"nemotron-4-15b": "nemotron_4_15b", "gemma3-1b": "gemma3_1b",
            "qwen1.5-0.5b": "qwen1_5_0_5b", "qwen2-0.5b": "qwen2_0_5b",
            "mamba2-780m": "mamba2_780m", "qwen2-vl-2b": "qwen2_vl_2b",
            "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
            "zamba2-7b": "zamba2_7b"}

_NOT_PORTED = ["mixtral-8x7b", "seamless-m4t-medium"]


def _mod(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"config {name!r} is not ported yet (ROADMAP Queue 1)")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ARCHS}")
    return importlib.import_module(f".{_MODULES[name]}", __package__)


def get(name: str):
    return _mod(name).config()


def reduced(name: str):
    return _mod(name).reduced()


def list_archs() -> List[str]:
    return list(ARCHS)

"""The gated MLP shared by DeepSeek's leading dense layer and its shared
experts (ported from ``repro.models.blocks``: ``init_mlp``, ``mlp``).
``dense_block`` is still to port (ROADMAP Queue 1 item 6)."""
from __future__ import annotations

from typing import Dict

import torch

from .common import Initializer, activation


def init_mlp(init: Initializer, d: int, f: int, L: int,
             gated: bool = True) -> Dict:
    p = {
        "w_up": init.tensor((L, d, f), fan_in=d),
        "w_down": init.tensor((L, f, d), fan_in=f),
    }
    if gated:
        p["w_gate"] = init.tensor((L, d, f), fan_in=d)
    return p


def mlp(p: Dict, x: torch.Tensor, act: str) -> torch.Tensor:
    fn = activation(act)
    if "w_gate" in p:
        return (fn(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    return fn(x @ p["w_up"]) @ p["w_down"]

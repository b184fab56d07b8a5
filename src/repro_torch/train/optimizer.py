"""AdamW (own implementation) + LR schedules + gradient clipping.

Ported from ``repro.train.optimizer``: ``AdamWConfig``, ``OptState``,
``lr_at`` (cosine, warmup-stable-decay and constant, in float32 step
arithmetic with the ``(s + 1) / warmup`` ramp), ``init_opt_state``
(float32 moments), ``global_norm`` and ``adamw_update`` (clip by the global
norm, bias correction, decoupled weight decay on ``ndim >= 2`` leaves
only).  Trees are nested dicts of tensors (:mod:`.tree`); every update is
computed into new tensors, as ``repro``'s is.  ``repro``'s
``opt_state_specs`` (a ZeRO-1 ``PartitionSpec`` helper for GSPMD) is not
ported: the port runs its data-parallel lanes stacked on one card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from .tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    schedule: str = "cosine"     # cosine | wsd | constant


class OptState(NamedTuple):
    step: torch.Tensor           # int32 scalar
    mu: Any
    nu: Any


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an int tensor): a float32 scalar."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp((s + 1.0) / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        decay = 1.0
    elif cfg.schedule == "wsd":
        # warmup-stable-decay: linear decay over the last 10%
        tail = 0.1 * cfg.total_steps
        decay = torch.clamp((cfg.total_steps - s) / max(tail, 1.0),
                            cfg.min_lr_frac, 1.0)
    else:  # cosine
        frac = torch.clamp(s / max(cfg.total_steps, 1), 0.0, 1.0)
        decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
            1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * decay


def init_opt_state(params) -> OptState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = tree_leaves(params)[0].device if tree_leaves(params) else None
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree_leaves(tree)))


def _is_matrix(p) -> bool:
    return p.dim() >= 2


def adamw_update(
    cfg: AdamWConfig,
    params,
    grads,
    state: OptState,
) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = lr_at(cfg, state.step)
    sf = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                     device=sf.device), sf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                     device=sf.device), sf)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        mh = m / b1c
        vh = v / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps)
        if _is_matrix(p):
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), m, v

    out = [upd(*xs) for xs in zip(tree_leaves(params), tree_leaves(grads),
                                  tree_leaves(state.mu),
                                  tree_leaves(state.nu))]
    new_params = tree_unflatten(params, [t[0] for t in out])
    mu = tree_unflatten(params, [t[1] for t in out])
    nu = tree_unflatten(params, [t[2] for t in out])
    return new_params, OptState(step, mu, nu), {"gnorm": gnorm, "lr": lr}

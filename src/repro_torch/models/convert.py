"""Carry ``repro``'s weights over to the port.

``repro``'s ``Model.init_params`` and the port's build the same parameter
tree (names, shapes, stacking, expert layout ``[L, e_phys, D, F]``) but draw
from different generators.  :func:`from_reference_params` takes the
reference's tree as numpy arrays (``jax.device_get`` of it) and returns the
port's, so that both sides compute the same function in the parity tests.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .. import resolve_device


def _to_tensor(a: Any, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":         # ml_dtypes' bfloat16: by bits
        bits = torch.from_numpy(np.array(a).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def from_reference_params(ref_params: Dict, device=None) -> Dict:
    """The reference's parameter tree (nested dicts of numpy arrays) as the
    port's (nested dicts of tensors on ``device``), dtypes kept."""
    device = resolve_device(device)
    return {k: from_reference_params(v, device) if isinstance(v, dict)
            else _to_tensor(v, device) for k, v in ref_params.items()}

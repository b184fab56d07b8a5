"""repro_torch: the PyTorch/CUDA port of ``repro``.

Ported so far: the distributed AMG set-up and solve (``sparse``, ``amg``,
``core``), MoE serving of DeepSeek-V2-Lite and serving of the Mamba-2 SSM
and Zamba2 hybrid families (``models``, ``serve``, ``configs``), the
metrics, spans and Perfetto export (``obs``), and measurement and
calibration (``profile``: the trace recorder and the fit of
``MachineParams`` to measured exchanges).
The package mirrors ``repro``'s subpackages and public names, so a parity
test can call both sides with the same arguments.  It imports ``torch`` and
``numpy`` only.  Host planning is numpy; vectors, plans' index arrays, ELL
blocks and activations live in torch tensors on one device, with the
solve's ranks and the MoE dispatch's EP lanes stacked along a leading dim.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Every kernel wrapper dispatches on the device of the tensors it is given:
CPU tensors take the plain torch version, CUDA tensors the hand-written
CUDA kernel (see :mod:`repro_torch.kernels`).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless one is given.

    A CUDA device without an index resolves to the current one, so the
    result compares equal to the ``.device`` of tensors made on it."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device

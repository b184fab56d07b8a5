"""repro_torch.runtime: the control loop's records.

Ported from ``repro.runtime`` so far: :class:`~.controller.RefitEvent`, the
record of one online re-calibration of ``ServeEngine(observe=True)``.  The
elastic pieces (``ResizeEvent``, ``RebalanceEvent``, ``ElasticController``
and the ``elastic``, ``straggler`` and ``checkpoint`` modules) are still to
port (ROADMAP Queue 1).
"""
from .controller import RefitEvent

__all__ = ["RefitEvent"]

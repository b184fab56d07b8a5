"""Records of the serving engine's control loop.

Ported from ``repro.runtime.controller``: :class:`RefitEvent` only.  The
elastic controller and its resize and rebalance events wait for the
elastic slice (ROADMAP Queue 1).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class RefitEvent:
    """One online re-calibration: ``MachineParams`` re-fitted from
    pure-exchange samples of production steps (``ServeEngine(observe=True)``
    every ``refit_every`` decode steps)."""

    step: int                  # decode step / observation that triggered it
    params_name: str           # name of the fitted MachineParams
    rel_rmse: float            # fit goodness
    n_samples: int             # merged rate samples that entered the fit

    def __str__(self) -> str:
        return (f"refit@step{self.step}: params='{self.params_name}' "
                f"rel_rmse={self.rel_rmse:.3f} n={self.n_samples}")

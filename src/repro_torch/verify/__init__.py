"""repro_torch.verify: static plan and kernel verification.

Ported from ``repro.verify``.  The planners hand the whole communication
pattern to the runtime; this package checks the whole pattern.  Three
passes:

* :mod:`.invariants`: host-side structural checks over patterns, plans,
  partitions, the ELL layouts the kernels read (the blocked one
  bucket-major) and MoE dispatch geometry (conservation, duality, round
  conflict-freedom, bucket exhaustiveness).
* :mod:`.executor_audit`: run a bound rank-stacked executor under a
  dispatch mode and prove its gathers, rank permutations and scatters are
  its plan's rounds with the same index arrays, none depending on the
  data (in place of ``repro``'s jaxpr audit).
* :mod:`.kernel_budget`: the SpMV footprint estimators agree with what the
  K1-K4 launches read, every CUDA kernel's attributes fit the card's
  limits, and K4's bucket-skip maps cover every nonzero exactly once.

Entry points: :func:`verify_hierarchy` sweeps every operator of a
``DistributedHierarchy``; ``ServeEngine.verify()`` checks a serving
engine's MoE plans; ``PlanCache`` calls :func:`verify_cache_value`,
:func:`audit_executor` and :func:`audit_dense_executor` on insertion when
:func:`verify_enabled`, i.e. ``REPRO_VERIFY=1``.  Verification changes no
computed value.  Every failure raises :class:`VerifyError` with a
diagnostic naming the offending rank / slot / bucket.
"""
from __future__ import annotations

import os
from typing import Dict

from .invariants import (
    VerifyError,
    verify_cache_value,
    verify_collective,
    verify_dense_plan,
    verify_device_ell,
    verify_device_plan,
    verify_ell_blocked,
    verify_moe_dispatch,
    verify_moe_plan,
    verify_partition,
    verify_pattern,
    verify_plan,
    verify_round_schedule,
)
from .executor_audit import (
    IndexRecord,
    audit_dense_executor,
    audit_executor,
    trace_indexing,
)
from .kernel_budget import (
    blocked_kernel_actual_bytes,
    check_bucket_map,
    check_build_log_registers,
    check_kernel_attributes,
    flash_prefill_smem_bytes,
    flat_kernel_actual_bytes,
    live_buckets,
    read_kernel_attributes,
    verify_bucket_map,
    verify_kernel_budget,
)

__all__ = [
    "VerifyError",
    "verify_enabled",
    "verify_pattern",
    "verify_round_schedule",
    "verify_plan",
    "verify_device_plan",
    "verify_collective",
    "verify_partition",
    "verify_device_ell",
    "verify_ell_blocked",
    "verify_moe_plan",
    "verify_moe_dispatch",
    "verify_dense_plan",
    "verify_cache_value",
    "IndexRecord",
    "trace_indexing",
    "audit_executor",
    "audit_dense_executor",
    "flat_kernel_actual_bytes",
    "blocked_kernel_actual_bytes",
    "verify_kernel_budget",
    "flash_prefill_smem_bytes",
    "check_kernel_attributes",
    "read_kernel_attributes",
    "check_build_log_registers",
    "check_bucket_map",
    "live_buckets",
    "verify_bucket_map",
    "verify_dist_op",
    "verify_hierarchy",
]


def verify_enabled() -> bool:
    """Whether plan-cache insertions verify (``REPRO_VERIFY``, the knob
    ``repro`` reads).

    Read per call, not at import, so tests and operators can flip it at
    runtime.  Verification is host-side numpy over plan metadata plus one
    run of each new executor on a zero input: cheap next to planning, not
    free, so it is off unless asked for.  It changes no computed value.
    """
    return os.environ.get("REPRO_VERIFY", "0").lower() in ("1", "true", "on")


def verify_dist_op(op, *, value_bytes: int = 8, operands=None
                   ) -> Dict[str, int]:
    """All static checks for one distributed operator (a ``DistOp``):
    partition, bound collective, device layout, kernel budget, and for
    blocked layouts bucket-map exhaustiveness over the full window and
    both overlap windows (local / ghost) when an exchange exists.
    ``operands``: the bucket-major ``(cols, vals)`` a bound blocked product
    reads (``make_distributed_spmv``'s ``operands``), checked in place of
    the copy made from the host form.

    Each pass runs under an obs span (``verify/<pass>``), so
    ``obs.report()`` breaks verification wall time out per pass.
    """
    from ..obs import default_obs

    obs = default_obs()
    counts: Dict[str, int] = {}

    def tick(k: str) -> None:
        counts[k] = counts.get(k, 0) + 1

    with obs.span("verify/partition"):
        verify_partition(op.part)
    tick("partitions")
    if op.coll is not None:
        with obs.span("verify/collective"):
            verify_collective(op.coll)
        tick("collectives")
    ell = op.ell
    if hasattr(ell, "bucket_K"):
        with obs.span("verify/blocked_layout"):
            cols, vals = operands if operands is not None else (None, None)
            verify_ell_blocked(ell, op.part, cols, vals)
            live = live_buckets(ell)
            verify_bucket_map(ell, live=live)
            if op.coll is not None and ell.n_ghost_buckets:
                verify_bucket_map(ell, bucket_hi=ell.n_local_buckets,
                                  live=live)
                verify_bucket_map(ell, bucket_lo=ell.n_local_buckets,
                                  live=live)
        tick("blocked_layouts")
    else:
        with obs.span("verify/flat_layout"):
            verify_device_ell(ell, op.part)
        tick("flat_layouts")
    with obs.span("verify/kernel_budget"):
        verify_kernel_budget(ell, op.kernel, value_bytes=value_bytes)
    tick("kernel_budgets")
    return counts


def verify_hierarchy(h) -> Dict[str, int]:
    """Sweep every operator (A, R, P per level) of a
    ``DistributedHierarchy``; returns check counts per category.  A
    blocked operator's bound product is checked on the bucket-major
    operands it reads.  Raises :class:`VerifyError` on the first violated
    invariant, naming the level and the operator."""
    from ..obs import default_obs

    counts: Dict[str, int] = {"levels": len(h.levels)}
    with default_obs().span("verify/hierarchy", levels=len(h.levels)):
        for lv in h.levels:
            for name, op in (("A", lv.A), ("R", lv.R), ("P", lv.P)):
                if op is None:
                    continue
                bound = h.bound_product(lv.index, name)
                try:
                    for k, v in verify_dist_op(
                            op, value_bytes=h.value_bytes,
                            operands=getattr(bound, "operands", None)
                    ).items():
                        counts[k] = counts.get(k, 0) + v
                except VerifyError as e:
                    raise VerifyError(
                        f"level {lv.index} operator {name}: {e}",
                        level=lv.index, operator=name, **e.context,
                    ) from e
    return counts

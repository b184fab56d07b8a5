"""Core: locality-aware persistent neighborhood collectives (the paper's
contribution), planned on host and executed as rank-stacked round programs
on one device.

Layers: ``plan`` (patterns/plans/round schedules) -> ``locality`` (the three
aggregation strategies) -> ``selection`` (Section-5 dynamic selector) ->
``collectives`` (device executor) -> ``neighborhood`` (the
``NeighborAlltoallV`` facade) -> ``cache`` (plan/executor cache keyed on
pattern fingerprints, amortizing init across solves).  Beside them,
``dynexchange`` discovers the partners of irregular exchanges and ``dense``
plans and runs the ring / recursive-doubling / hierarchical dense
collectives.
"""
from .plan import (
    CommPattern,
    CommPlan,
    CommStep,
    Message,
    PlanStats,
    StepStats,
    Topology,
    color_rounds,
    padded_wire_volume,
)
from .locality import STRATEGIES, build_plan, plan_full, plan_partial, plan_standard
from .costmodel import LASSEN, MachineParams, plan_time, stats_time
from .selection import SelectionReport, per_pattern_best, select_plan
from .collectives import (
    DevicePlan,
    build_device_plan,
    make_executor,
    pack_local_values,
    unpack_ghosts,
)
from .neighborhood import NeighborAlltoallV
from .dynexchange import DiscoveryStats, SparseDynamicExchange
from .dense import (
    DENSE_COLLECTIVES,
    DensePlan,
    DenseRound,
    DenseSelection,
    bind_dense,
    build_dense_plan,
    dense_fingerprint,
    dense_round_runner,
    dense_time,
    dense_variants,
    even_counts,
    pack_dense_input,
    select_dense,
    unpack_dense_output,
)
from .cache import (
    PlanCache,
    default_plan_cache,
    pattern_fingerprint,
    plan_cache_key,
)

__all__ = [
    "PlanCache", "default_plan_cache", "pattern_fingerprint", "plan_cache_key",
    "DiscoveryStats", "SparseDynamicExchange",
    "DENSE_COLLECTIVES", "DensePlan", "DenseRound", "DenseSelection",
    "bind_dense", "build_dense_plan", "dense_fingerprint",
    "dense_round_runner", "dense_time", "dense_variants", "even_counts",
    "pack_dense_input", "select_dense", "unpack_dense_output",
    "CommPattern", "CommPlan", "CommStep", "Message", "PlanStats", "StepStats",
    "Topology", "color_rounds", "padded_wire_volume",
    "STRATEGIES", "build_plan", "plan_full", "plan_partial", "plan_standard",
    "LASSEN", "MachineParams", "plan_time", "stats_time",
    "SelectionReport", "per_pattern_best", "select_plan",
    "DevicePlan", "build_device_plan", "make_executor",
    "pack_local_values", "unpack_ghosts",
    "NeighborAlltoallV",
]

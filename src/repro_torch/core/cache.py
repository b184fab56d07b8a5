"""Persistent plan/executor cache: ``MPI_*_init`` semantics across solves.

MPI's persistent neighborhood collectives amortize the expensive init
(plan construction, leader election, dedup) over the iterations of *one*
solve.  This cache extends the amortization across solves and across
operators that share a communication pattern: repeated AMG cycles on the
same matrix, a rebuilt hierarchy on an unchanged grid, or several operators
whose halos coincide all hit the same entry.

Entries are keyed on a *pattern fingerprint* (a content hash of the
pattern's ownership/needs arrays) plus topology, strategy, value width and
machine params, so two equal patterns hit regardless of object identity.
Bound executors (which carry the plan's index arrays on a device) are
cached one level down, keyed additionally on the device.

The MoE dispatch has the same amortization surface
(``models.moe.moe_plan_for``): :meth:`PlanCache.moe_plan` holds dispatch
plans keyed on geometry plus the routing-pattern fingerprint, and
:meth:`PlanCache.moe_executor` the per-geometry dispatch executors, with the
reference's keys.  So do the dense collectives (``core.dense``):
:meth:`PlanCache.dense_collective` holds selected round schedules keyed on
the dense fingerprint, variant and machine params, and
:meth:`PlanCache.dense_executor` their bound executors.  The flat hit/miss
counters aggregate the plan namespaces (``collective`` + ``moe_plan`` +
``dense_plan``) and the executor namespaces (``executor`` +
``moe_executor`` + ``dense_executor``), as ``repro``'s do.

Every lookup also counts into the obs registry (``plan_cache/hits``,
``plan_cache/misses`` and ``plan_cache/evictions``, labelled by namespace),
which records only while ``repro_torch.obs`` is enabled.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Tuple

import numpy as np

from .. import resolve_device
from ..obs import default_obs, now
from .costmodel import LASSEN, MachineParams
from .neighborhood import NeighborAlltoallV
from .plan import CommPattern, Topology

_OBS = default_obs()
_M_HITS = _OBS.counter("plan_cache/hits", "plan-cache hits by namespace")
_M_MISSES = _OBS.counter("plan_cache/misses",
                         "plan-cache misses by namespace")
_M_EVICTIONS = _OBS.counter("plan_cache/evictions",
                            "LRU evictions by namespace")


def _hash_array(h, name: str, arr: np.ndarray) -> None:
    """Feed one array to the hash with an unambiguous framing.

    The field name, dtype, rank and shape are encoded ahead of the raw
    bytes, so two patterns whose arrays happen to serialize to the same
    byte stream cannot collide, and the digest is a pure function of
    content, identical across processes and interpreter runs.
    """
    a = np.ascontiguousarray(arr)
    h.update(name.encode())
    h.update(b"\x00")
    h.update(str(a.dtype).encode())
    h.update(np.asarray([a.ndim, *a.shape], dtype=np.int64).tobytes())
    h.update(a.tobytes())


def pattern_fingerprint(pattern: CommPattern) -> str:
    """Content hash of a pattern: equal content -> equal fingerprint.

    Fields are hashed in a fixed order, each framed with its
    name/dtype/shape (:func:`_hash_array`), and the variable-length
    ``needs`` list is prefixed with its count.
    """
    h = hashlib.blake2b(digest_size=16)
    _hash_array(h, "owner_proc", pattern.owner_proc)
    _hash_array(h, "owner_slot", pattern.owner_slot)
    _hash_array(h, "n_local", pattern.n_local)
    h.update(np.int64(len(pattern.needs)).tobytes())
    for q, need in enumerate(pattern.needs):
        _hash_array(h, f"needs[{q}]", need)
    return h.hexdigest()


def plan_cache_key(
    pattern: CommPattern,
    topo: Topology,
    strategy: str,
    value_bytes: int,
    params: MachineParams,
) -> Tuple:
    """Full cache key: everything ``NeighborAlltoallV.init`` depends on.

    ``params`` matters because ``strategy="auto"`` selects per machine
    model; the frozen dataclass itself is the key component (not just its
    name) so a params object with changed rates and an unchanged name
    cannot hit a plan selected under the old rates.
    """
    return (
        pattern_fingerprint(pattern),
        topo.n_procs,
        topo.procs_per_region,
        strategy,
        value_bytes,
        params,
    )


@dataclass
class PlanCache:
    """Cache of initialized collectives and bound executors.

    Bounded: each namespace (``collective``, ``executor``, ``moe_plan``,
    ``moe_executor``, ``dense_plan``, ``dense_executor``) holds at most
    :attr:`max_entries` entries under LRU eviction; evictions are counted.

    **Stats schema.**  The per-namespace ``_ns_counts`` dicts (filled by
    :meth:`_lookup`, the single increment point) are the only source of
    truth; :meth:`snapshot` is the one schema::

        {"counters":   {hits, misses, exec_hits, exec_misses, evictions},
         "namespaces": {ns: {hits, misses, entries}},   # 6 namespaces
         "entries": int, "max_entries": int,
         "init_seconds_spent": float, "init_seconds_saved": float}

    where the flat ``counters`` aggregate the plan namespaces and the
    executor namespaces.  :meth:`counters` and :meth:`stats` are views of
    it.
    """

    evictions: int = 0
    max_entries: int = 512          # per namespace; <= 0 disables the bound
    init_seconds_spent: float = 0.0
    init_seconds_saved: float = 0.0
    _colls: Dict[Tuple, NeighborAlltoallV] = field(default_factory=dict)
    _execs: Dict[Tuple, Callable] = field(default_factory=dict)
    # MoE dispatch: (plan, init seconds) keyed on geometry + routing
    # fingerprint, and executors keyed on the fingerprint-free geometry
    _moe_plans: Dict[Tuple, Tuple[Any, float]] = field(default_factory=dict)
    _moe_execs: Dict[Tuple, Callable] = field(default_factory=dict)
    # dense collectives: ((DensePlan, DenseSelection), init seconds) keyed
    # on the dense fingerprint + variant + params, and bound executors
    _dense_plans: Dict[Tuple, Tuple[Any, float]] = field(default_factory=dict)
    _dense_execs: Dict[Tuple, Callable] = field(default_factory=dict)
    _ns_counts: Dict[str, Dict[str, int]] = field(default_factory=dict)

    PLAN_NAMESPACES = ("collective", "moe_plan", "dense_plan")
    EXEC_NAMESPACES = ("executor", "moe_executor", "dense_executor")

    def _ns_sum(self, namespaces: Tuple[str, ...], which: str) -> int:
        return sum(self._ns(ns)[which] for ns in namespaces)

    @property
    def hits(self) -> int:
        return self._ns_sum(self.PLAN_NAMESPACES, "hits")

    @property
    def misses(self) -> int:
        return self._ns_sum(self.PLAN_NAMESPACES, "misses")

    @property
    def exec_hits(self) -> int:
        return self._ns_sum(self.EXEC_NAMESPACES, "hits")

    @property
    def exec_misses(self) -> int:
        return self._ns_sum(self.EXEC_NAMESPACES, "misses")

    def _ns(self, name: str) -> Dict[str, int]:
        return self._ns_counts.setdefault(name, {"hits": 0, "misses": 0})

    def _lookup(self, store: Dict, key, ns: str):
        """LRU-aware get: a hit moves the entry to the recent end.

        The single hit/miss increment point: the flat properties and the
        obs ``plan_cache/*`` counters both hang off it."""
        entry = store.get(key)
        if entry is not None:
            store[key] = store.pop(key)    # dicts iterate in insert order
            self._ns(ns)["hits"] += 1
            _M_HITS.inc(ns=ns)
        else:
            self._ns(ns)["misses"] += 1
            _M_MISSES.inc(ns=ns)
        return entry

    def _insert(self, store: Dict, key, value, ns: str) -> None:
        if self.max_entries > 0 and len(store) >= self.max_entries:
            store.pop(next(iter(store)))   # least-recently used
            self.evictions += 1
            _M_EVICTIONS.inc(ns=ns)
        store[key] = value

    def collective(
        self,
        pattern: CommPattern,
        topo: Topology,
        strategy: str = "auto",
        value_bytes: int = 8,
        params: MachineParams = LASSEN,
    ) -> NeighborAlltoallV:
        """Cached ``NeighborAlltoallV.init``: a hit skips re-planning."""
        key = plan_cache_key(pattern, topo, strategy, value_bytes, params)
        coll = self._lookup(self._colls, key, "collective")
        if coll is not None:
            self.init_seconds_saved += coll.init_seconds
            return coll
        coll = NeighborAlltoallV.init(
            pattern, topo, strategy, value_bytes=value_bytes, params=params
        )
        self.init_seconds_spent += coll.init_seconds
        self._insert(self._colls, key, coll, "collective")
        return coll

    def executor(
        self,
        pattern: CommPattern,
        topo: Topology,
        device=None,
        strategy: str = "auto",
        value_bytes: int = 8,
        params: MachineParams = LASSEN,
    ) -> Callable:
        """Cached bound executor (plan + index arrays on ``device``)."""
        ckey = plan_cache_key(pattern, topo, strategy, value_bytes, params)
        # silent lookup: binding an executor for an already-initialized
        # collective is not a plan-cache hit (it never risked re-planning)
        coll = self._colls.get(ckey)
        if coll is None:
            coll = self.collective(pattern, topo, strategy, value_bytes, params)
        device = resolve_device(device)
        key = (ckey, str(device))
        fn = self._lookup(self._execs, key, "executor")
        if fn is not None:
            return fn
        fn = coll.bind(device)
        self._insert(self._execs, key, fn, "executor")
        return fn

    def moe_plan(self, key: Tuple, build: Callable[[], Any]) -> Any:
        """Cached MoE dispatch plan: ``key`` carries the dispatch geometry
        (mesh, tokens per lane, top-k, mode, capacity factor, ...) and the
        routing-pattern fingerprint; ``build`` runs only on a miss."""
        entry = self._lookup(self._moe_plans, key, "moe_plan")
        if entry is not None:
            self.init_seconds_saved += entry[1]
            return entry[0]
        t0 = now()
        value = build()
        secs = now() - t0
        self.init_seconds_spent += secs
        self._insert(self._moe_plans, key, (value, secs), "moe_plan")
        return value

    def moe_executor(self, key: Tuple,
                     build: Callable[[], Callable]) -> Callable:
        """Cached dispatch executor of an MoE plan geometry."""
        fn = self._lookup(self._moe_execs, key, "moe_executor")
        if fn is not None:
            return fn
        fn = build()
        self._insert(self._moe_execs, key, fn, "moe_executor")
        return fn

    def dense_collective(
        self,
        collective: str,
        counts: np.ndarray,
        topo: Topology,
        variant: str = "auto",
        value_bytes: int = 8,
        params: MachineParams = LASSEN,
    ) -> Tuple[Any, Any]:
        """Cached ``dense.select_dense``: returns ``(DensePlan,
        DenseSelection)``; a hit skips building and scoring the candidate
        round schedules."""
        from .dense import dense_cache_key, select_dense

        key = dense_cache_key(collective, counts, topo, variant,
                              value_bytes, params)
        entry = self._lookup(self._dense_plans, key, "dense_plan")
        if entry is not None:
            self.init_seconds_saved += entry[1]
            return entry[0]
        t0 = now()
        plan, sel = select_dense(collective, counts, topo, variant,
                                 value_bytes, params)
        secs = now() - t0
        self.init_seconds_spent += secs
        self._insert(self._dense_plans, key, ((plan, sel), secs),
                     "dense_plan")
        return plan, sel

    def dense_executor(self, plan, device=None) -> Callable:
        """Cached ``dense.bind_dense`` on ``device`` (default ``cuda``),
        keyed on the plan fingerprint and the device."""
        from .dense import bind_dense

        device = resolve_device(device)
        key = (plan.fingerprint, str(device))
        fn = self._lookup(self._dense_execs, key, "dense_executor")
        if fn is not None:
            return fn
        fn = bind_dense(plan, device)
        self._insert(self._dense_execs, key, fn, "dense_executor")
        return fn

    def snapshot(self) -> Dict[str, Any]:
        """The one stats schema (see the class docstring): flat aggregates
        under ``"counters"``, per-namespace breakdowns under
        ``"namespaces"``."""
        sizes = {"collective": len(self._colls), "executor": len(self._execs),
                 "moe_plan": len(self._moe_plans),
                 "moe_executor": len(self._moe_execs),
                 "dense_plan": len(self._dense_plans),
                 "dense_executor": len(self._dense_execs)}
        return {
            "counters": {
                "hits": self.hits,
                "misses": self.misses,
                "exec_hits": self.exec_hits,
                "exec_misses": self.exec_misses,
                "evictions": self.evictions,
            },
            "namespaces": {
                ns: {**self._ns(ns), "entries": sizes[ns]} for ns in sizes
            },
            "entries": sum(sizes.values()),
            "max_entries": self.max_entries,
            "init_seconds_spent": self.init_seconds_spent,
            "init_seconds_saved": self.init_seconds_saved,
        }

    def counters(self) -> Dict[str, int]:
        """View: the flat ``snapshot()["counters"]`` hit/miss aggregates;
        one taken before a rebuild, diffed after, attributes plan and
        executor work to that rebuild."""
        return self.snapshot()["counters"]

    def stats(self) -> Dict[str, Any]:
        """View: the snapshot's counters hoisted to the top level, then
        ``"namespaces"``, the entry counts and the init seconds."""
        snap = self.snapshot()
        return {**snap["counters"],
                **{k: v for k, v in snap.items() if k != "counters"}}

    def clear(self) -> None:
        self._colls.clear()
        self._execs.clear()
        self._moe_plans.clear()
        self._moe_execs.clear()
        self._dense_plans.clear()
        self._dense_execs.clear()


_DEFAULT_CACHE: "PlanCache | None" = None


def default_plan_cache() -> PlanCache:
    """Process-wide cache shared by AMG setups unless a private one is
    passed."""
    global _DEFAULT_CACHE
    if _DEFAULT_CACHE is None:
        _DEFAULT_CACHE = PlanCache()
    return _DEFAULT_CACHE

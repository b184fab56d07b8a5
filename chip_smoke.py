#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It drives the port's main path, the paper's distributed AMG solve, on the
card and fails (non-zero exit) if any phase fails:

1. builds the CUDA SpMV kernels (K1-K4) from ``src/repro_torch/csrc``;
2. checks that the exchange executor delivers ghosts bitwise equal to the
   host oracle ``CommPlan.execute_numpy`` for the three strategies;
3. solves the paper problem (524,288 rows, 8 ranks, ``procs_per_region=4``,
   Section-5 ``auto`` strategy under the paper machine model) with every
   kernel variant x overlap schedule, holds each residual history against
   the host solver's on the same hierarchy, counts the kernel launches,
   profiles a few V-cycles (device busy time and idle share) and records
   every kernel call of one V-cycle;
4. holds every kernel against its plain torch version, in float64 and
   float32, on the operands the solves gave it (each distinct call of the
   recorded V-cycles), and times it there; plus an edge case (ragged last
   row block, an empty bucket, ``hi == lo`` for K3, ``M > counts[i]`` for
   K4) and a stress case the solves never make (K2/K3 over all buckets of
   the fine level's bucketed layout);
5. checks that the solves launched every kernel.

Its last line is ``{"ok": true, "device": {...}}``.  It uses no JAX.
"""
from __future__ import annotations

import contextlib
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

N_PROCS = 8
PROCS_PER_REGION = 4
V_CYCLES = 10
PROFILE_CYCLES = 3
EDGE_ROWS_CUT = 37          # rows dropped to make the last row block ragged
TOL = {"float64": 1e-12, "float32": 1e-5}
# rtol/atol of the residual-history comparison: the reference's own bar
# (tests/multidevice_progs/check_distributed_amg.py)
HIST_RTOL, HIST_ATOL = 1e-8, 1e-15
# NVIDIA H100 SXM data sheet: memory rate and non-tensor-core peaks
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}
SOURCE = "src/repro_torch/csrc/spmv_ell.cu"
REPLACES = {
    "spmv_ell": "src/repro/kernels/spmv_ell/spmv_ell.py:80",
    "spmv_ell_blocked": "src/repro/kernels/spmv_ell/spmv_ell.py:125",
    "spmv_ell_blocked_partial": "src/repro/kernels/spmv_ell/spmv_ell.py:190",
    "spmv_ell_blocked_skip": "src/repro/kernels/spmv_ell/spmv_ell.py:266",
}
# kernel -> the public wrapper in repro_torch.kernels.spmv_ell.ops
OPS_FN = {
    "spmv_ell": "spmv",
    "spmv_ell_blocked": "spmv_blocked",
    "spmv_ell_blocked_partial": "spmv_blocked_partial",
    "spmv_ell_blocked_skip": "spmv_blocked_skip",
}
SOLVES = [("flat", "off"), ("flat", "on"), ("blocked", "off"),
          ("blocked", "on")]


def log(*args) -> None:
    print(*args, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"FAILED: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------- timing
def time_ms(fn, sync, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call: CUDA events around ``iters`` calls on the
    card.  On the CPU (a rehearsal, not a measurement) the host clock
    around one call."""
    import torch

    if not sync:
        s = time.perf_counter()
        fn()
        return (time.perf_counter() - s) * 1e3
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def rel_err(got, want) -> float:
    """max |got - want| / max |want| (normwise: rows whose sum cancels to
    near zero would make an elementwise ratio meaningless)."""
    import torch

    scale = float(torch.max(torch.abs(want))) if want.numel() else 0.0
    diff = float(torch.max(torch.abs(got - want))) if want.numel() else 0.0
    return diff / max(scale, 1e-300)


# ----------------------------------------------------------- kernel calls
# A kernel call is (kernel name, the keyword arguments of its ops wrapper).
def kernel_call(name: str, a: dict):
    from repro_torch.kernels.spmv_ell import ops

    return getattr(ops, OPS_FN[name])(**a)


def plain_call(name: str, a: dict):
    """The same call through the plain torch version (on any device)."""
    from repro_torch.kernels.spmv_ell import ref

    cols, vals, x = a["cols"], a["vals"], a["x"]
    if name == "spmv_ell":
        return ref.spmv_ell_ref(cols, vals, x)
    if name == "spmv_ell_blocked":
        return ref.spmv_ell_blocked_ref(cols, vals, x, a["block_cols"])
    if name == "spmv_ell_blocked_partial":
        return ref.spmv_ell_blocked_partial_ref(
            cols, vals, x, a["y0"], a["bucket_lo"], a["bucket_hi"],
            a["block_cols"], a["n_buckets"])
    return ref.spmv_ell_blocked_skip_ref(
        cols, vals, x, a["bucket_lists"], a["bucket_counts"], a["n_buckets"],
        a["block_cols"], min(a["block_rows"], cols.shape[1]),
        a["bucket_base"], a["y0"])


def cast(a: dict, dtype) -> dict:
    """The call with its values, x and y0 in ``dtype``."""
    import torch

    return {k: v.to(dtype) if torch.is_tensor(v) and v.is_floating_point()
            else v for k, v in a.items()}


def n_buckets(a: dict) -> int:
    """Buckets of the call's layout (K2 covers them all with its x)."""
    return a.get("n_buckets", a["x"].shape[1] // a["block_cols"])


def bucket_window(a: dict):
    """(first bucket, number of buckets) that a blocked call's x covers."""
    nb = a["x"].shape[1] // a["block_cols"]
    return a.get("bucket_lo", a.get("bucket_base", 0)), nb


def work(name: str, a: dict):
    """(bytes, flops) of the call: each input read once, the output written
    once, counting only the entries this call's data makes it visit (for K4
    the listed buckets and the x slices they touch)."""
    import torch

    cols, vals, x, y0 = a["cols"], a["vals"], a["x"], a.get("y0")
    P_, R, W = cols.shape
    vb = vals.element_size()
    io = P_ * R * vb + (0 if y0 is None else y0.numel() * vb)
    x_bytes = x.numel() * vb
    if name in ("spmv_ell", "spmv_ell_blocked"):
        entries = cols.numel()
    elif name == "spmv_ell_blocked_partial":
        K = W // a["n_buckets"]
        entries = P_ * R * (a["bucket_hi"] - a["bucket_lo"]) * K
    else:
        lists, counts = a["bucket_lists"], a["bucket_counts"]
        K = W // a["n_buckets"]
        br = min(a["block_rows"], R)
        nrb, M = lists.shape[1:]
        rb_rows = torch.clamp(
            R - torch.arange(nrb, device=cols.device) * br, max=br)
        entries = int((counts.long() * rb_rows).sum()) * K
        listed = torch.arange(M, device=cols.device) < counts[..., None]
        live = sum(len(set(lists[p][listed[p]].tolist()))
                   for p in range(P_))
        x_bytes = live * a["block_cols"] * vb
        io += (lists.numel() + counts.numel()) * 4
    return entries * (4 + vb) + x_bytes + io, 2 * entries


def library_call(name: str, a: dict):
    """One torch sparse product computing the call (cuSPARSE on the card):
    a block-diagonal CSR of the stored nonzeros over the buckets x covers.
    A yardstick only; the port never calls it."""
    import torch

    cols, vals, x, y0 = a["cols"], a["vals"], a["x"], a.get("y0")
    P_, R, W = cols.shape
    dev = cols.device
    if name == "spmv_ell":
        c, v = cols.long(), vals
    else:
        lo, nb = bucket_window(a)
        K = W // n_buckets(a)
        base = torch.repeat_interleave(
            torch.arange(nb, device=dev) * a["block_cols"], K)
        c = cols[..., lo * K:(lo + nb) * K].long() + base
        v = vals[..., lo * K:(lo + nb) * K]
    n = x.shape[1]
    keep = v != 0
    rows = torch.arange(P_ * R, device=dev).reshape(P_, R, 1).expand(c.shape)
    gcols = c + torch.arange(P_, device=dev)[:, None, None] * n
    A = torch.sparse_coo_tensor(
        torch.stack([rows[keep], gcols[keep]]), v[keep], (P_ * R, P_ * n),
    ).coalesce().to_sparse_csr()
    xc = x.reshape(-1, 1)
    if y0 is None:
        return lambda: torch.sparse.mm(A, xc)
    return lambda: torch.addmm(y0.reshape(-1, 1), A, xc)


def check_call(name: str, a: dict, label: str) -> float:
    """The kernel against its plain version in float64 and float32; fails
    beyond the tolerance.  Returns the float64 max |difference|."""
    import torch

    abs_err = 0.0
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[1]
        ad = cast(a, dtype)
        got, want = kernel_call(name, ad), plain_call(name, ad)
        if got.shape != want.shape:
            fail(f"{name} {label} {dname}: shape {tuple(got.shape)} vs "
                 f"{tuple(want.shape)}")
        err = rel_err(got, want)
        if not err <= TOL[dname]:
            fail(f"{name} {label} {dname}: max rel error {err} > "
                 f"{TOL[dname]}")
        if dtype == torch.float64 and got.numel():
            abs_err = float(torch.max(torch.abs(got - want)))
    return abs_err


def time_call(name: str, a: dict, on_card: bool,
              library: bool = False) -> dict:
    """Kernel and plain ms of the call, its bound, and the library's ms."""
    nbytes, flops = work(name, a)
    dname = str(a["vals"].dtype).split(".")[1]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dname]
    rec = dict(
        ms=time_ms(lambda: kernel_call(name, a), on_card),
        plain_ms=time_ms(lambda: plain_call(name, a), on_card),
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        mbytes=nbytes / 1e6,
        library_ms=(time_ms(library_call(name, a), on_card) if library
                    else None),
    )
    return rec


def call_shape(name: str, a: dict) -> str:
    s = f"cols {list(a['cols'].shape)} x {list(a['x'].shape)}"
    if name != "spmv_ell":
        lo, nb = bucket_window(a)
        s += f" buckets [{lo}, {lo + nb}) of {n_buckets(a)}"
    if a.get("y0") is not None:
        s += " +y0"
    return s


# ------------------------------------------------------ recording the path
@contextlib.contextmanager
def recording_kernel_calls(calls: dict):
    """Record the kernel calls the distributed SpMVs make while the block
    runs: ``calls[(kernel, operand, window)] = [times called, arguments of
    the first call]``.  The calls still go through to the wrappers."""
    from repro_torch.kernels.spmv_ell import ops
    from repro_torch.sparse import device as spmv_module

    saved = {}
    for name, fn_name in OPS_FN.items():
        fn = getattr(ops, fn_name)
        sig = inspect.signature(fn)

        def record(*args, _fn=fn, _sig=sig, _name=name, **kwargs):
            bound = _sig.bind(*args, **kwargs)
            bound.apply_defaults()
            a = dict(bound.arguments)
            key = (_name, a["cols"].data_ptr(), a.get("bucket_lo"),
                   a.get("bucket_hi"), a.get("bucket_base"),
                   tuple(a["x"].shape))
            calls.setdefault(key, [0, a])[0] += 1
            return _fn(*args, **kwargs)

        saved[fn_name] = getattr(spmv_module, fn_name)
        setattr(spmv_module, fn_name, record)
    try:
        yield calls
    finally:
        for fn_name, fn in saved.items():
            setattr(spmv_module, fn_name, fn)


# ------------------------------------------------------------ kernel phase
def path_kernel_phase(recorded: dict, on_card: bool) -> dict:
    """Every distinct kernel call of the recorded V-cycles against its
    plain version, timed; per configuration and kernel, the V-cycle's sum
    over its calls; per kernel, the record of its largest call."""
    results = {}
    for config, calls in recorded.items():
        tag = "/".join(config)
        per_kernel = {}
        for (name, *_), (n_calls, a) in calls.items():
            per_kernel.setdefault(name, []).append((n_calls, a))
        for name, group in per_kernel.items():
            tot = dict(calls=0, ms=0.0, plain_ms=0.0, bound_ms=0.0)
            rec = results.setdefault(name, {"max_abs_err": 0.0})
            for n_calls, a in group:
                rec["max_abs_err"] = max(rec["max_abs_err"],
                                         check_call(name, a, tag))
                t = time_call(name, a, on_card)
                tot["calls"] += n_calls
                for k in ("ms", "plain_ms", "bound_ms"):
                    tot[k] += n_calls * t[k]
                if t["mbytes"] > rec.get("mbytes", -1.0):
                    rec.update(mbytes=t["mbytes"], config=tag, args=a)
            log(f"kernel {name:26s} path {tag:11s}: {len(group)} distinct "
                f"calls, {tot['calls']} per V-cycle, within tolerance in "
                f"float64 and float32; per V-cycle kernel "
                f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, "
                f"bound {tot['bound_ms']:.4f} ms")
    for name, rec in results.items():
        a = rec.pop("args")
        rec.update(time_call(name, a, on_card, library=True))
        log(f"  {name} largest path call ({rec['config']}: "
            f"{call_shape(name, a)}, {rec['mbytes']:.1f} MB): kernel "
            f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, library "
            f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']})")
    return results


def synthetic_calls(h, device, block_cols: int, edge: bool, gen):
    """Kernel calls on the fine level's operands that the solves do not
    make.  ``edge``: the last rows dropped (ragged last row block), bucket 1
    emptied, K1-K4 with a carried y0 for K3/K4.  Otherwise the stress case:
    K2 over every bucket and K3 over the local buckets of the fine level's
    bucketed layout (the solves take K4 there)."""
    import numpy as np
    import torch

    from repro_torch.sparse import (
        partition_csr,
        partitioned_to_ell,
        partitioned_to_ell_blocked,
        row_block_bucket_map,
    )

    part = partition_csr(h.levels[0].A, N_PROCS)
    flat = partitioned_to_ell(part)
    blk = partitioned_to_ell_blocked(part, block_cols)
    lc, lv = flat.local_cols, flat.local_vals
    cols, vals = blk.cols, blk.vals.copy()
    if edge:
        R = flat.row_pad - EDGE_ROWS_CUT
        lc, lv = lc[:, :R], lv[:, :R]
        cols, vals = cols[:, :R], vals[:, :R].copy()
        vals[:, :, blk.K:2 * blk.K] = 0.0       # bucket 1: empty
        blk.cols, blk.vals, blk.row_pad = cols, vals, R
    lists, counts = row_block_bucket_map(blk)
    t = lambda v: torch.as_tensor(np.ascontiguousarray(v), device=device)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64
                           ).to(device)

    C, Cl, bc = blk.n_buckets, blk.n_local_buckets, block_cols
    R = cols.shape[1]
    cols, vals, y0 = t(cols), t(vals), rnd(N_PROCS, R)
    xb = rnd(N_PROCS, C * bc)
    k3 = dict(cols=cols, vals=vals, x=xb[:, :Cl * bc].contiguous(), y0=y0,
              bucket_lo=0, bucket_hi=Cl, n_buckets=C, block_cols=bc)
    k2 = dict(cols=cols, vals=vals, x=xb, block_cols=bc)
    if not edge:
        return [("spmv_ell_blocked", k2), ("spmv_ell_blocked_partial", k3)]
    if R % 256 == 0:
        fail("edge case: last row block is not ragged")
    if not bool((counts < lists.shape[2]).any()):
        fail("edge case: no row block with M > counts[i]")
    empty = dict(k3, x=xb[:, :0], bucket_lo=Cl)
    if kernel_call("spmv_ell_blocked_partial", empty) is not y0:
        fail("K3 with hi == lo did not return y0")
    xf = rnd(N_PROCS, flat.in_pad + 1)
    xf[:, -1] = 0.0                               # the zero sentinel
    return [
        ("spmv_ell", dict(cols=t(lc), vals=t(lv), x=xf)),
        ("spmv_ell_blocked", k2),
        ("spmv_ell_blocked_partial", k3),
        ("spmv_ell_blocked_skip", dict(
            cols=cols, vals=vals, x=xb, bucket_lists=t(lists),
            bucket_counts=t(counts), n_buckets=C, block_cols=bc,
            bucket_base=0, y0=y0, block_rows=256)),
    ]


def synthetic_kernel_phase(h, device, block_cols: int, on_card: bool,
                           results: dict) -> None:
    """The edge and stress calls against their plain versions; the stress
    calls are timed (and logged only: the solves never make them)."""
    import torch

    gen = torch.Generator().manual_seed(0)
    for label, edge in (("edge", True), ("stress", False)):
        for name, a in synthetic_calls(h, device, block_cols, edge, gen):
            err = check_call(name, a, label)
            rec = results.setdefault(name, {"max_abs_err": 0.0})
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            msg = (f"kernel {name:26s} {label:6s} ({call_shape(name, a)}): "
                   f"within tolerance in float64 and float32")
            if not edge:
                t = time_call(name, a, on_card)
                msg += (f"; kernel {t['ms']:.4f} ms, plain "
                        f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} "
                        f"ms ({t['mbytes']:.1f} MB)")
            log(msg)


# ---------------------------------------------------------- exchange phase
def exchange_phase(h, device, on_card: bool):
    """The executor's ghosts equal the host oracle's, bit for bit."""
    import numpy as np
    import torch

    from repro_torch.core import NeighborAlltoallV, Topology
    from repro_torch.core.collectives import pack_local_values, unpack_ghosts
    from repro_torch.sparse import partition_csr

    part = partition_csr(h.levels[0].A, N_PROCS)
    topo = Topology(N_PROCS, PROCS_PER_REGION)
    rng = np.random.default_rng(1)
    local = [rng.normal(size=(int(n), 1)) for n in part.pattern.n_local]
    for strategy in ("standard", "partial", "full"):
        coll = NeighborAlltoallV.init(part.pattern, topo, strategy)
        exec_fn = coll.bind(device)
        x = torch.as_tensor(pack_local_values(coll.plan, local),
                            device=device)
        got = unpack_ghosts(coll.plan, exec_fn(x))
        want = coll(local)
        same = all(np.array_equal(g, w) for g, w in zip(got, want))
        ms = time_ms(lambda: exec_fn(x), on_card)
        log(f"exchange {strategy:8s}: rounds={coll.device_plan.n_rounds} "
            f"ghosts={part.pattern.total_ghosts()} bitwise_equal={same} "
            f"{ms:.4f} ms")
        if not same:
            fail(f"exchange {strategy}: ghosts differ from execute_numpy")


# ------------------------------------------------------------- solve phase
def _union_us(intervals) -> float:
    """Total length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def profile_solve(dh, b, wall_ms: float) -> dict:
    """``PROFILE_CYCLES`` V-cycles under ``torch.profiler``: the card's busy
    time per V-cycle (union of its kernel intervals), the idle share
    against the unprofiled ``wall_ms``, device operations per V-cycle, and
    the ops that take the most host and device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dh.solve(b, tol=0.0, max_iters=PROFILE_CYCLES)
        torch.cuda.synchronize()
    on_device = [e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = _union_us((e.time_range.start, e.time_range.end)
                        for e in on_device) / 1e3 / PROFILE_CYCLES
    avgs = prof.key_averages()

    def top(attr):
        ranked = sorted(avgs, key=lambda e: -getattr(e, attr))[:5]
        return ", ".join(
            f"{e.key[:48]} {getattr(e, attr) / 1e3 / PROFILE_CYCLES:.3f}"
            for e in ranked if getattr(e, attr))

    return dict(busy_ms=busy_ms, idle_share=1.0 - busy_ms / wall_ms,
                device_ops=len(on_device) / PROFILE_CYCLES,
                top_host=top("self_cpu_time_total"),
                top_device=top("self_device_time_total"))


def solve_phase(h, b, device, block_cols: int, on_card: bool,
                v_cycles: int):
    """Every variant x overlap solve against the host history.  Returns the
    results of each solve and, per configuration, the kernel calls of one
    recorded V-cycle."""
    import numpy as np
    import torch

    from repro_torch.amg import DistributedHierarchy, solve
    from repro_torch.core import PlanCache
    from repro_torch.kernels import LAUNCHES

    t0 = time.perf_counter()
    _, host_hist = solve(h, b, tol=0.0, max_iters=v_cycles)
    log(f"host solve: {v_cycles} V-cycles in "
        f"{time.perf_counter() - t0:.2f} s, final rel residual "
        f"{host_hist[-1]:.3e}")
    cache = PlanCache()
    per_solve, recorded = {}, {}
    for variant, overlap in SOLVES:
        t0 = time.perf_counter()
        dh = DistributedHierarchy.setup(
            h, N_PROCS, procs_per_region=PROCS_PER_REGION, strategy="auto",
            cache=cache, spmv_variant=variant, spmv_overlap=overlap,
            spmv_block_cols=block_cols, device=device,
        )
        setup_s = time.perf_counter() - t0
        dh.solve(b, tol=0.0, max_iters=1)           # warm-up V-cycle
        before = dict(LAUNCHES)
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, hist = dh.solve(b, tol=0.0, max_iters=v_cycles)
        if on_card:
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / v_cycles
        counts = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        dev = float(np.max(np.abs(np.asarray(hist) - np.asarray(host_hist))
                           / np.maximum(np.abs(host_hist), 1e-300)))
        ok = len(hist) == len(host_hist) and np.allclose(
            hist, host_hist, rtol=HIST_RTOL, atol=HIST_ATOL)
        log(f"solve variant={variant} overlap={overlap}: setup "
            f"{setup_s:.2f} s, {ms:.3f} ms per V-cycle, max rel history "
            f"deviation {dev:.3e}, launches per V-cycle "
            f"{ {k: v / v_cycles for k, v in counts.items()} }")
        log(dh.describe())
        if not ok:
            fail(f"solve {variant}/{overlap}: history {hist} vs host "
                 f"{host_hist}")
        per_solve[(variant, overlap)] = dict(
            setup_s=setup_s, ms_per_vcycle=ms, max_rel_dev=dev,
            launches=counts)
        if on_card:
            prof = profile_solve(dh, b, ms)
            per_solve[(variant, overlap)].update(prof)
            log(f"  profile ({PROFILE_CYCLES} V-cycles): device busy "
                f"{prof['busy_ms']:.3f} ms per V-cycle, idle share "
                f"{prof['idle_share']:.3f}, {prof['device_ops']:.0f} device "
                f"ops per V-cycle\n  most host ms per V-cycle: "
                f"{prof['top_host']}\n  most device ms per V-cycle: "
                f"{prof['top_device']}")
        with recording_kernel_calls(recorded.setdefault(
                (variant, overlap), {})):
            dh.solve(b, tol=0.0, max_iters=1)
        del dh
    return per_solve, recorded


def run(device: str = "cuda", rows: int = 524_288, block_cols: int = 512,
        v_cycles: int = V_CYCLES) -> dict:
    """All phases at ``rows`` unknowns on ``device``, ``v_cycles`` timed
    V-cycles per solve; returns the kernel records, the launch counts of
    the main path and the solve results."""
    import numpy as np
    import torch

    from repro_torch.amg import build_hierarchy, paper_problem
    from repro_torch.kernels import LAUNCHES, reset_launches

    on_card = device == "cuda"
    t0 = time.perf_counter()
    h = build_hierarchy(paper_problem(rows))
    log(f"host setup: {time.perf_counter() - t0:.2f} s")
    log(h.describe())
    exchange_phase(h, device, on_card)
    b = np.random.default_rng(0).normal(size=h.levels[0].A.nrows)
    reset_launches()
    solves, recorded = solve_phase(h, b, device, block_cols, on_card,
                                   v_cycles)
    if on_card:
        torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    kernels = path_kernel_phase(recorded, on_card)
    synthetic_kernel_phase(h, device, block_cols, on_card, kernels)
    return dict(kernels=kernels, launches=launches, solves=solves)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels.spmv_ell import cuda

    smi = nvidia_smi_line()
    log(f"device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    lib = cuda.build()
    log(f"nvcc build: {time.perf_counter() - t0:.2f} s -> {lib.name}")
    for line in cuda.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    res = run("cuda")
    missing = [k for k, n in res["launches"].items() if n <= 0]
    log(f"kernels launched by the solves: {res['launches']}")
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    records = []
    for name in REPLACES:
        rec = res["kernels"][name]
        records.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=res["launches"][name], max_abs_err=rec["max_abs_err"],
            ms=rec["ms"], plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec["library_ms"],
        ))
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

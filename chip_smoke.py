#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It drives the port's three paths on the card and fails (non-zero exit) if
any phase fails:

1. builds the CUDA kernels K1-K8 from ``src/repro_torch/csrc``, one
   ``nvcc`` per source, in parallel;
2. AMG: checks that the exchange executor delivers ghosts bitwise equal to
   the host oracle ``CommPlan.execute_numpy`` for the three strategies;
3. solves the paper problem (524,288 rows, 8 ranks, ``procs_per_region=4``,
   Section-5 ``auto`` strategy under the paper machine model) with every
   kernel variant x overlap schedule, holds each residual history against
   the host solver's on the same hierarchy, counts the kernel launches,
   profiles a few V-cycles (device busy time and idle share) and records
   every kernel call of one V-cycle;
4. holds K1-K4 against their plain torch versions, in float64 and float32,
   on the operands the solves gave them (each distinct call of the
   recorded V-cycles), and times them there (each kernel's largest call
   also by its own device time under ``torch.profiler``, from a cold L2:
   :func:`cold_copies`); replays the largest K4 and K2 calls with a fault
   planted in the binding (each row block's last listed bucket dropped;
   the last bucket dropped), which the check must refuse; plus an edge case (ragged last row block, an empty
   bucket, ``hi == lo`` for K3, ``M > counts[i]`` for K4) and a stress
   case the solves never make (K2/K3 over all buckets of the fine level's
   bucketed layout);
5. serve: draws DeepSeek-V2-Lite at full width and depth in bf16 on the
   card (seeded) and serves six requests through ``ServeEngine`` on 8 EP
   lanes (2 pods x 4) under ``a2a``, ``hier``, ``hier_dedup`` and
   ``auto``, counting K5-K7 launches per prefill and decode step; replays
   every engine call of ``a2a`` and ``hier_dedup`` through the plain
   versions of K5-K7 with the same routing decisions (logits and greedy
   tokens must agree) and through the kernels with two K6 faults and two
   K7 faults planted in the binding (K6's last weight dropped; every
   lane's rows read from lane 0; ``q_offset`` ignored; the decode
   combine without its last key split; the oracle must refuse all
   four); checks that the modes agree under ample capacity; holds every
   K5-K7 call of one prefill and one decode step, and edge cases, against
   the plain versions in bf16 and float32 (K6 also on a table whose next
   row is NaN, which its sentinels must not read; K5 with indices -1, N
   and N + 5 before NaN rows, which must give zero rows), times the largest
   calls (from a cold L2), checks that K7 refuses a head dim it is not
   built for, and profiles a short serve run;
6. hybrid serve: draws zamba2-7b at full width and depth in bf16 on the
   card (seeded) and serves six requests through ``ServeEngine``, counting
   K7 / K8 calls and CUDA launches per prefill and decode step; holds
   every K7 / K8 call of one prefill and one decode step, and edge cases,
   against the plain versions in bf16 and float32, times the largest
   calls (from a cold L2), and profiles a short serve run; then, on the
   same weights in float32, replays every engine call through the
   kernels and through the plain versions of K7 and K8 (logits and greedy
   tokens must agree) and through the kernels with two K8 faults planted
   in the binding (the oracle must refuse both);
7. partitioned, last: builds the hierarchy of the AMG phases' matrix by the
   distributed setup (``DistributedHierarchy.setup_partitioned``: PMIS,
   interpolation and the Galerkin SpGEMM over discovered exchanges), holds
   it level by level to the host hierarchy (identical splittings, A / P / R
   within 1e-12, rho within 1e-6), solves it blocked/off against the host
   solver on its own hierarchy (K2 and K4 must launch; launches and a
   profile beside the host-built solve's), solves it with the coarsest
   level through a dense allgatherv (``coarse_gather`` auto / hier /
   ring: iterations within 2 of the distributed coarse solve, solution
   within 1e-8) and resumes a solve from its third iterate (``x0``);
   then runs the dense executor (``bind_dense``) for every collective x
   variant on three count sets, bitwise equal to ``execute_numpy``, timed;
8. calibrate, last (no profiler): times the rate probes
   (``profile.probe_plans`` on ``Topology(8, 4)``, 16,384 values a
   message, every strategy), the paper problem's exchanges
   (``measure_exchange_seconds``), its SpMVs flat/off and blocked/off
   (``measure_spmv_seconds``: K1, K2 and K4 must launch; impure, kept out
   of the fit), the dense plans on the coarsest counts
   (``measure_dense_seconds``) and the set-up's ``gather_A`` /
   ``gather_P`` patterns into one ``TraceRecorder``; fits
   ``MachineParams`` (``fit_trace`` under ``LASSEN``; trace and
   ``fitted_params.json`` saved to ``chiprun_out/calibrate/`` before the
   reference's gate: converged, finite, ``rel_rmse <= 10``); holds the fit
   to its round trip (a trace synthesized at the fit fits back within 1e-6
   on every rate the probes excite there) and to a planted fault (every
   time x 10 must fit to scaled rates); prints the pure samples' seconds
   against their rounds; fits the probes at 65,536 values apart;
   prints the selections under ``LASSEN`` against the fit (each level's
   strategy, the MoE modes of the served geometry, ``coarse_gather``) and
   the flips; and solves the paper problem with every ``auto`` under the
   fit and the card's own figures (:func:`card_figures`) against the host
   history, each level's choices beside ``LASSEN``'s and beside the faster
   measured SpMV;
9. checks that each path launched each of its kernels (the AMG solves
   the launches per V-cycle of ``VCYCLE_LAUNCHES``, the partitioned solve
   K2 and K4, the calibrate phase K1, K2 and K4), and prints one JSON
   line with every kernel's record: calls (``launches``) and
   ``cuda_launches`` on the main path (K1-K4 also
   ``partitioned_launches`` and ``calibrate_launches``), ``ms`` by CUDA events,
   ``device_ms`` and ``host_us`` (:func:`device_times`), bound, plain and
   library times.

Its last line is ``{"ok": true, "device": {...}}``.  It uses no JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import inspect
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

N_PROCS = 8
PROCS_PER_REGION = 4
V_CYCLES = 6
PROFILE_CYCLES = 3
EDGE_ROWS_CUT = 37          # rows dropped to make the last row block ragged
TOL = {"float64": 1e-12, "float32": 1e-5}
# rtol/atol of the residual-history comparison: the reference's own bar
# (tests/multidevice_progs/check_distributed_amg.py)
HIST_RTOL, HIST_ATOL = 1e-8, 1e-15
# NVIDIA H100 SXM data sheet: memory rate and non-tensor-core peaks
PEAK_BYTES_PER_S = 3.35e12
# (bf16: the tensor cores' dense rate)
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12, "bfloat16": 989e12}
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
# K1-K4 launches per V-cycle of each solve of the paper problem
VCYCLE_LAUNCHES = {
    ("flat", "off"): {"spmv_ell": 230},
    ("flat", "on"): {"spmv_ell": 230},
    ("blocked", "off"): {"spmv_ell_blocked": 78, "spmv_ell_blocked_skip": 37},
    ("blocked", "on"): {"spmv_ell_blocked_partial": 165,
                        "spmv_ell_blocked_skip": 65},
}


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
def device_times(fns: dict, on_card: bool, iters: int = 20,
                 warmup: int = 3) -> dict:
    """name -> (device ms, host us) per call of each function in ``fns``:
    the card's time for the call's own device work, from the device events
    ``torch.profiler`` records while the function runs ``warmup + iters``
    times in a profiler session of its own, each kernel's mean duration
    times its launches per call; and the host's time to issue one call,
    over ``iters`` calls issued back to back outside the profiler.
    (None, None) off the card: a CPU run has no device time.

    One session per function: a shared session cannot tell their events
    apart by time, the device clock is not aligned with the host's finely
    enough.  Means, not sums: the profiler was seen to record only some of
    a session's device events, so a sum would count the missing ones as
    zero.  A kernel is taken to launch ``round(events / calls)`` times a
    call, at least once; a shortfall is logged."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not on_card:
        return {k: (None, None) for k in fns}
    calls = warmup + iters
    out = {}
    for k, fn in fns.items():
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_us = (time.perf_counter() - t0) * 1e6 / iters
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels: dict = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                tot, n = kernels.get(e.name, (0.0, 0))
                kernels[e.name] = (
                    tot + e.time_range.end - e.time_range.start, n + 1)
        if not kernels:
            log(f"    ({k}: the profiler recorded no device event)")
            out[k] = (None, host_us)
            continue
        per_call = {e: max(1, round(n / calls))
                    for e, (_, n) in kernels.items()}
        recorded = sum(n for _, n in kernels.values())
        if recorded < calls * sum(per_call.values()):
            log(f"    ({k}: the profiler recorded {recorded} of "
                f"{calls * sum(per_call.values())} device events: "
                + ", ".join(f"{e[:40]} {n}"
                            for e, (_, n) in kernels.items()) + ")")
        dev_us = sum(tot / n * per_call[e] for e, (tot, n) in kernels.items())
        out[k] = (dev_us / 1e3, host_us)
    return out


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
            a["block_cols"])
    return ref.spmv_ell_blocked_skip_ref(
        cols, vals, x, a["bucket_lists"], a["bucket_counts"],
        a["block_cols"], min(a["block_rows"], cols.shape[2]),
        a["bucket_base"], a["y0"])


def cast(a: dict, dtype) -> dict:
    """The call with its values, x and y0 in ``dtype``."""
    import torch

    return {k: v.to(dtype) if torch.is_tensor(v) and v.is_floating_point()
            else v for k, v in a.items()}


def n_buckets(a: dict) -> int:
    """Buckets of the call's bucket-major [P, C, R, K] layout."""
    return a["cols"].shape[1]


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
    P_, R, K = cols.shape[0], cols.shape[-2], cols.shape[-1]
    vb = vals.element_size()
    io = P_ * R * vb + (0 if y0 is None else y0.numel() * vb)
    x_bytes = x.numel() * vb
    if name in ("spmv_ell", "spmv_ell_blocked"):
        entries = cols.numel()
    elif name == "spmv_ell_blocked_partial":
        entries = P_ * R * (a["bucket_hi"] - a["bucket_lo"]) * K
    else:
        lists, counts = a["bucket_lists"], a["bucket_counts"]
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
    P_, R = cols.shape[0], cols.shape[-2]
    dev = cols.device
    rows = torch.arange(P_ * R, device=dev).reshape(P_, R, 1)
    if name == "spmv_ell":
        c, v = cols.long(), vals
    else:
        lo, nb = bucket_window(a)
        off = torch.arange(nb, device=dev) * a["block_cols"]
        c = cols[:, lo:lo + nb].long() + off[None, :, None, None]
        v = vals[:, lo:lo + nb]
        rows = rows[:, None]
    n = x.shape[1]
    keep = v != 0
    rows = rows.expand(c.shape)
    gcols = c + (torch.arange(P_, device=dev) * n).reshape(
        (P_,) + (1,) * (c.dim() - 1))
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


# bytes that a pass over the cold copies of one call moves, against the L2
COLD_L2_PASSES = 2
# the most the cold copies of one call may hold on the card
COLD_COPIES_MAX_BYTES = 4 << 30


def cold_copies(name: str, a: dict, nbytes: int, l2: int) -> list:
    """Copies of the operands the call reads, so many that a pass over them
    moves ``COLD_L2_PASSES`` times the L2 (``l2`` bytes): calling them in
    turn, each call finds its operands evicted by the calls before it.  A call
    that moves more than the L2 by itself is its own copy (K4's fine-level
    call: x, which every row block reads, stays warm, as on the path).  A
    K3 copy holds its bucket range only, rebased to start at bucket 0: the
    same products in the same order."""
    import torch

    n = -(-COLD_L2_PASSES * l2 // nbytes)
    if nbytes >= l2 or n <= 1:
        return [a]
    if name == "gather_rows":
        # a K5 copy holds only the rows its indices read, the indices
        # remapped onto them: the same rows in the same order
        rows, inv = torch.unique(a["idx"], return_inverse=True)
        a = dict(a, x=a["x"][rows.long()], idx=inv.to(a["idx"].dtype))
    if name == "combine_rows":
        a = k6_compact(a)
    if name == "spmv_ell_blocked_partial":
        lo, hi = a["bucket_lo"], a["bucket_hi"]
        a = dict(a, cols=a["cols"][:, lo:hi], vals=a["vals"][:, lo:hi],
                 bucket_lo=0, bucket_hi=hi - lo, n_buckets=hi - lo)
    held = sum(v.numel() * v.element_size() for v in a.values()
               if torch.is_tensor(v))
    if n * held > COLD_COPIES_MAX_BYTES:
        fail(f"{name}: {n} cold copies would hold {n * held} bytes")
    return [{k: v.clone(memory_format=torch.contiguous_format)
             if torch.is_tensor(v) else v for k, v in a.items()}
            for _ in range(n)]


def k6_rows(a: dict):
    """(flat row of each index of a lane-form K6 call, which are real) of
    buf [G, R, D] seen as [G * R, D]; the sentinels' rows are 0."""
    import torch

    buf, idx = a["buf"], a["idx"]
    G, R = buf.shape[:2]
    real = idx.long() < R
    lane = torch.arange(G, device=idx.device)[:, None, None] * R
    return torch.where(real, idx.long(), 0) + lane, real


def k6_compact(a: dict) -> dict:
    """A lane-form K6 call on one lane holding only the real rows its
    indices read, plus one zero row no index reads (the library call's
    ``padding_idx``); the real indices remapped onto them, in order, the
    sentinels moved to the new R: the same rows summed in the same order.
    The indices as the kernel takes them, int32 (the layer passes its
    int64 slots, which the wrapper casts: an op of the layer's, not of
    the kernel's, left out of the kernel's device time as before the lane
    form, when the layer cast them itself)."""
    import torch

    buf = a["buf"]
    flat, real = k6_rows(a)
    rows, inv = torch.unique(flat[real], return_inverse=True)
    U = rows.numel()
    idx = torch.full_like(a["idx"], U + 1, dtype=torch.int32)
    idx[real] = inv.to(torch.int32)
    table = buf.reshape(-1, buf.shape[2])[rows]
    table = torch.cat([table, table.new_zeros((1, table.shape[1]))])
    K = idx.shape[2]
    return dict(a, buf=table[None], idx=idx.reshape(1, -1, K),
                w=a["w"].reshape(1, -1, K))


def time_call(name: str, a: dict, on_card: bool,
              library: bool = False) -> dict:
    """Kernel and plain ms of the call and its bound; with ``library``,
    the library's ms, and the kernel's and the library's own device ms
    from a cold L2 (each call of :func:`device_times` on the next of the
    :func:`cold_copies`) and the kernel's host us per call."""
    import torch

    nbytes, flops = work(name, a)
    dname = str(a["vals"].dtype).split(".")[1]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dname]
    rec = dict(
        ms=time_ms(lambda: kernel_call(name, a), on_card),
        plain_ms=time_ms(lambda: plain_call(name, a), on_card),
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        mbytes=nbytes / 1e6, library_ms=None,
    )
    if library:
        rec["library_ms"] = time_ms(library_call(name, a), on_card)
        copies = [a]
        if on_card:
            l2 = torch.cuda.get_device_properties(
                a["cols"].device).L2_cache_size
            copies = cold_copies(name, a, nbytes, l2)
        args = itertools.cycle(copies)
        libs = itertools.cycle([library_call(name, c) for c in copies])
        t = device_times({"kernel": lambda: kernel_call(name, next(args)),
                          "library": lambda: next(libs)()}, on_card)
        rec["device_ms"], rec["host_us"] = t["kernel"]
        rec["library_device_ms"] = t["library"][0]
        rec["cold_copies"] = len(copies)
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
    the last call]``.  The last, not the first: each level's first product
    in a V-cycle is of the zero vector (the smoother starts from x = 0),
    which every kernel gets right.  The calls still go through to the
    wrappers."""
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
            entry = calls.setdefault(key, [0, a])
            entry[0] += 1
            entry[1] = a
            return _fn(*args, **kwargs)

        saved[fn_name] = getattr(spmv_module, fn_name)
        setattr(spmv_module, fn_name, record)
    try:
        yield calls
    finally:
        for fn_name, fn in saved.items():
            setattr(spmv_module, fn_name, fn)


# ------------------------------------------------------------ kernel phase
def fmt_ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f}"


def path_kernel_phase(recorded: dict, on_card: bool):
    """Every distinct kernel call of the recorded V-cycles against its
    plain version, timed; per configuration and kernel, the V-cycle's sum
    over its calls; per kernel, the record of its largest call.  Returns
    the records and the readings of the planted faults."""
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
    largest = {}
    for name, rec in results.items():
        a = largest[name] = rec.pop("args")
        rec.update(time_call(name, a, on_card, library=True))
        log(f"  {name} largest path call ({rec['config']}: "
            f"{call_shape(name, a)}, {rec['mbytes']:.1f} MB): kernel "
            f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, library "
            f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}); device ms {fmt_ms(rec['device_ms'])} "
            f"(library {fmt_ms(rec['library_device_ms'])}; cold L2, "
            f"{rec['cold_copies']} copies), host us per call "
            f"{fmt_ms(rec['host_us'])}")
    return results, planted_spmv_faults(largest)


def planted_spmv_faults(largest: dict) -> dict:
    """The largest K4 and K2 path calls replayed through the kernels with a
    fault planted in the binding (the sources untouched): K4 with each row
    block's last listed bucket dropped (its count one less), K2 with the
    layout's last bucket dropped (cols, vals and x cut to C - 1 buckets).
    The kernel-vs-plain check must refuse both, in float64 and float32;
    returns each fault's max rel error by dtype."""
    import torch

    def k4_drops_last_listed(a):
        counts = torch.clamp(a["bucket_counts"] - 1, min=0)
        return kernel_call("spmv_ell_blocked_skip",
                           dict(a, bucket_counts=counts))

    def k2_drops_last_bucket(a):
        bc = a["block_cols"]
        return kernel_call("spmv_ell_blocked", dict(
            a, cols=a["cols"][:, :-1].contiguous(),
            vals=a["vals"][:, :-1].contiguous(),
            x=a["x"][:, :-bc].contiguous()))

    faults = {
        "K4 drops each row block's last listed bucket": (
            "spmv_ell_blocked_skip", k4_drops_last_listed),
        "K2 drops its last bucket": ("spmv_ell_blocked",
                                     k2_drops_last_bucket),
    }
    readings = {}
    for label, (name, faulty) in faults.items():
        errs = {}
        for dtype in (torch.float64, torch.float32):
            dname = str(dtype).split(".")[1]
            ad = cast(largest[name], dtype)
            errs[dname] = rel_err(faulty(ad), plain_call(name, ad))
        readings[label] = errs
        if any(err <= TOL[d] for d, err in errs.items()):
            fail(f"the kernel check misses a planted fault ({label}): max "
                 f"rel error {errs} within {TOL}")
        log(f"{name} check refuses a planted fault, {label}: max rel error "
            f"against the plain version {errs['float64']:.3e} (float64), "
            f"{errs['float32']:.3e} (float32); tolerance {TOL}")
    return readings


def synthetic_calls(h, device, block_cols: int, edge: bool, gen):
    """Kernel calls on the fine level's operands that the solves do not
    make.  ``edge``: the last rows dropped (ragged last row block), bucket 1
    emptied, K1-K4 with a carried y0 for K3/K4.  Otherwise the stress case:
    K2 over every bucket and K3 over the local buckets of the fine level's
    bucketed layout (the solves take K4 there)."""
    import numpy as np
    import torch

    from repro_torch.kernels.spmv_ell import to_bucket_major
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
    cols, vals = (to_bucket_major(a, C, device) for a in (cols, vals))
    y0 = rnd(N_PROCS, R)
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
    results of each solve, per configuration the kernel calls of one
    recorded V-cycle, and the host solver's history."""
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
        counts = {k: LAUNCHES[k] - before[k] for k in REPLACES}
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
    return per_solve, recorded, host_hist


# ------------------------------------------------- partitioned phase
PARTITIONED = ("blocked", "off")     # the partitioned solve's variant / overlap
COARSE_GATHERS = ("auto", "hier", "ring")
COARSE_TOL, COARSE_MAX_ITERS = 1e-8, 60
WARM_CYCLES = 3                      # the warm start resumes after these
DENSE_N = 1 << 20                    # values of the dense executor's vectors


def sparse_max_diff(X, Y) -> float:
    """max |X - Y| over the union of both sparsity patterns, never
    densified; inf if the shapes differ."""
    import numpy as np

    if tuple(X.shape) != tuple(Y.shape):
        return float("inf")
    n = X.shape[1]
    keys = np.concatenate([
        M.row_indices().astype(np.int64) * n + M.indices.astype(np.int64)
        for M in (X, Y)])
    vals = np.concatenate([X.data, -Y.data])
    _, inv = np.unique(keys, return_inverse=True)
    acc = np.bincount(inv, weights=vals)
    return float(np.abs(acc).max()) if len(acc) else 0.0


def check_setup_levels(h, hh) -> dict:
    """The distributed setup's assembled hierarchy ``hh`` against the host
    ``build_hierarchy``'s ``h``, at the reference's bars
    (``tests/multidevice_progs/check_distributed_setup.py``): the same
    level count, identical splittings, A / P / R within 1e-12, rho within
    1e-6 relative."""
    import numpy as np

    if hh.n_levels != h.n_levels:
        fail(f"partitioned setup: {hh.n_levels} levels, host {h.n_levels}")
    worst = dict(op=0.0, rho=0.0)
    for k, (lh, ld) in enumerate(zip(h.levels, hh.levels)):
        if lh.splitting is not None and not (
                ld.splitting is not None
                and np.array_equal(lh.splitting, ld.splitting)):
            fail(f"partitioned setup L{k}: splitting differs from the host")
        pairs = [("A", lh.A, ld.A)]
        if lh.P is not None:
            if ld.P is None:
                fail(f"partitioned setup L{k}: no P where the host has one")
            pairs += [("P", lh.P, ld.P), ("R", lh.R, ld.R)]
        for name, X, Y in pairs:
            d = sparse_max_diff(X, Y)
            worst["op"] = max(worst["op"], d)
            if not d < 1e-12:
                fail(f"partitioned setup L{k}: {name} differs from the "
                     f"host's by {d}")
        rel = abs(lh.rho - ld.rho) / max(lh.rho, 1.0)
        worst["rho"] = max(worst["rho"], rel)
        if not rel < 1e-6:
            fail(f"partitioned setup L{k}: rho {ld.rho} vs host {lh.rho}")
    return worst


def partitioned_phase(h, b, host_setup_s: float, device, block_cols: int,
                      on_card: bool, v_cycles: int, host_built: dict,
                      coarse_max_iters: int = COARSE_MAX_ITERS):
    """The distributed setup (``setup_partitioned``) of the fine matrix of
    ``h`` over ``N_PROCS`` ranks, held level by level to ``h``; its
    blocked/off solve against the host solver on its own hierarchy, with
    launches and a profile beside the host-built solve's (``host_built``);
    the coarse allgatherv in every mode against the distributed coarse
    solve, to ``COARSE_TOL`` or ``coarse_max_iters`` V-cycles (the
    reference's bar: iterations within 2, solution within 1e-8); and the
    warm start.  Returns the phase's numbers and the
    kernel launches of the partitioned solve's timed V-cycles."""
    import numpy as np
    import torch

    from repro_torch.amg import (
        DistributedHierarchy,
        partition_fine_matrix,
        solve,
    )
    from repro_torch.core import PlanCache
    from repro_torch.kernels import LAUNCHES, reset_launches

    variant, overlap = PARTITIONED
    blocks, off = partition_fine_matrix(h.levels[0].A, N_PROCS)
    cache = PlanCache()
    t0 = time.perf_counter()
    dh = DistributedHierarchy.setup_partitioned(
        blocks, off, procs_per_region=PROCS_PER_REGION, strategy="auto",
        cache=cache, spmv_variant=variant, spmv_overlap=overlap,
        spmv_block_cols=block_cols, device=device,
    )
    setup_s = time.perf_counter() - t0
    info = dh.setup_info
    log(f"partitioned setup: {setup_s:.2f} s (distributed setup and the "
        f"lowering; host build_hierarchy {host_setup_s:.2f} s in this run), "
        f"{cache.stats()['namespaces']['collective']['misses']} persistent "
        "collectives planned")
    log(info.describe())
    hh = info.to_host_hierarchy()
    worst = check_setup_levels(h, hh)
    log(f"partitioned setup matches the host hierarchy: {h.n_levels} "
        f"levels, splittings identical, max operator difference "
        f"{worst['op']:.3e}, max rho rel difference {worst['rho']:.3e}")

    t0 = time.perf_counter()
    _, host_hist = solve(hh, b, tol=0.0, max_iters=v_cycles)
    log(f"host solve on the partitioned hierarchy: {v_cycles} V-cycles in "
        f"{time.perf_counter() - t0:.2f} s")
    dh.solve(b, tol=0.0, max_iters=1)               # warm-up V-cycle
    if on_card:
        torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    _, hist = dh.solve(b, tol=0.0, max_iters=v_cycles)
    if on_card:
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / v_cycles
    launches = {k: LAUNCHES[k] for k in REPLACES}
    per_cycle = {k: n / v_cycles for k, n in launches.items() if n}
    dev = float(np.max(np.abs(np.asarray(hist) - np.asarray(host_hist))
                       / np.maximum(np.abs(host_hist), 1e-300)))
    log(f"partitioned solve {variant}/{overlap}: {ms:.3f} ms per V-cycle, "
        f"max rel history deviation {dev:.3e}, launches per V-cycle "
        f"{per_cycle} (host-built {variant}/{overlap}: "
        f"{VCYCLE_LAUNCHES[PARTITIONED]})")
    log(dh.describe())
    if not (len(hist) == len(host_hist) and np.allclose(
            hist, host_hist, rtol=HIST_RTOL, atol=HIST_ATOL)):
        fail(f"partitioned solve: history {hist} vs host {host_hist}")
    out = dict(setup_s=setup_s, host_setup_s=host_setup_s,
               ms_per_vcycle=ms, max_rel_dev=dev, launches=launches,
               n_levels=info.n_levels, setup_records=info.records)
    if on_card:
        prof = profile_solve(dh, b, ms)
        out.update(prof)
        log(f"  profile ({PROFILE_CYCLES} V-cycles): device busy "
            f"{prof['busy_ms']:.3f} ms per V-cycle, idle share "
            f"{prof['idle_share']:.3f}, {prof['device_ops']:.0f} device ops "
            f"per V-cycle (host-built {variant}/{overlap}: "
            f"{host_built['ms_per_vcycle']:.3f} ms wall, "
            f"{host_built['busy_ms']:.3f} busy, idle "
            f"{host_built['idle_share']:.3f}, "
            f"{host_built['device_ops']:.0f} ops)\n"
            f"  most device ms per V-cycle: {prof['top_device']}")

    # the coarse allgatherv in every mode, on the same levels
    def to_tol(d):
        """(solution, history, wall ms per V-cycle) of a solve to
        COARSE_TOL."""
        if on_card:
            torch.cuda.synchronize()
        t = time.perf_counter()
        x, hist_d = d.solve(b, tol=COARSE_TOL, max_iters=coarse_max_iters)
        if on_card:
            torch.cuda.synchronize()
        return x, hist_d, (time.perf_counter() - t) * 1e3 / len(hist_d)

    x_off, hist_off, ms_off = to_tol(dh)
    log(f"coarse_gather=off: {len(hist_off)} iterations to "
        f"{hist_off[-1]:.3e}, {ms_off:.3f} ms per V-cycle")
    out["coarse"] = {"off": dict(iters=len(hist_off), ms_per_vcycle=ms_off)}
    for cg in COARSE_GATHERS:
        dc = DistributedHierarchy(
            dh.levels, dh.device, dh.topo, dh.cache, dh.dtype, dh.strategy,
            dh.params, dh.value_bytes, coarse_gather=cg)
        before = dict(LAUNCHES)
        x, hist_cg, ms_cg = to_tol(dc)
        n = len(hist_cg)
        rel = float(np.max(np.abs(x - x_off)) / np.max(np.abs(x_off)))
        per = {k: (LAUNCHES[k] - before[k]) / n for k in REPLACES
               if LAUNCHES[k] - before[k]}
        log(f"coarse_gather={cg}: {n} iterations (off {len(hist_off)}), "
            f"final {hist_cg[-1]:.3e}, {ms_cg:.3f} ms per V-cycle, solution "
            f"rel max difference {rel:.3e}, launches per V-cycle {per}; "
            f"{dc.coarse_selection}")
        if not (n <= len(hist_off) + 2 and rel < 1e-8):
            fail(f"coarse_gather={cg}: {n} iterations (off "
                 f"{len(hist_off)}), final {hist_cg[-1]}, solution off by "
                 f"{rel}")
        rec = dict(iters=n, rel=rel, ms_per_vcycle=ms_cg,
                   chosen=dc.coarse_selection.chosen,
                   launches_per_vcycle=per)
        if on_card and cg == "auto":
            rec.update(profile_solve(dc, b, ms_cg))
            log(f"  profile coarse_gather=auto: {rec['device_ops']:.0f} "
                f"device ops per V-cycle (off {out['device_ops']:.0f}), "
                f"busy {rec['busy_ms']:.3f} ms, idle share "
                f"{rec['idle_share']:.3f}")
        out["coarse"][cg] = rec
        del dc

    # the warm start resumes the history after WARM_CYCLES V-cycles
    warm = min(WARM_CYCLES, v_cycles - 1)
    x_w, _ = dh.solve(b, tol=0.0, max_iters=warm)
    _, tail = dh.solve(b, tol=0.0, max_iters=v_cycles - warm, x0=x_w)
    want = hist[warm:]
    if not (len(tail) == len(want) and np.allclose(
            tail, want, rtol=HIST_RTOL, atol=HIST_ATOL)):
        fail(f"warm start: history {tail} vs the full solve's {want}")
    log(f"warm start from V-cycle {warm}: {len(tail)} V-cycles, history "
        "equal to the full solve's at rtol 1e-8, atol 1e-15")
    counts = np.diff(np.asarray(dh.levels[-1].A.part.col_offsets))
    return out, [int(c) for c in counts]


def dense_phase(coarse_counts, device, on_card: bool,
                dense_n: int = DENSE_N) -> list:
    """``bind_dense`` for every dense collective x variant under
    ``Topology(N_PROCS, PROCS_PER_REGION)`` on three count sets (the
    coarsest level's, an even and a ragged split of ``dense_n`` values),
    float64: bitwise equal to ``execute_numpy``, and timed by CUDA events
    over 20 calls."""
    import numpy as np
    import torch

    from repro_torch.core import (
        DENSE_COLLECTIVES,
        Topology,
        bind_dense,
        build_dense_plan,
        dense_variants,
        even_counts,
        pack_dense_input,
        unpack_dense_output,
    )

    topo = Topology(N_PROCS, PROCS_PER_REGION)
    where = (nvidia_smi_line() if on_card
             else "the CPU (a rehearsal, not a measurement)")
    log(f"dense executor, float64, ms by CUDA events over 20 calls on "
        f"{where}")
    rng = np.random.default_rng(2)
    cuts = np.sort(rng.choice(np.arange(1, dense_n), N_PROCS - 1,
                              replace=False))
    count_sets = {
        "coarsest": np.asarray(coarse_counts, dtype=np.int64),
        "even": even_counts(dense_n, N_PROCS),
        "ragged": np.diff(np.concatenate([[0], cuts, [dense_n]])),
    }
    rows = []
    for label, counts in count_sets.items():
        n = int(counts.sum())
        for coll in DENSE_COLLECTIVES:
            if coll == "allgatherv":
                vals = [rng.normal(size=int(c)) for c in counts]
            else:
                vals = [rng.normal(size=n) for _ in range(N_PROCS)]
            for variant in dense_variants(coll, topo):
                plan = build_dense_plan(coll, counts, topo, variant)
                fn = bind_dense(plan, device)
                x = torch.as_tensor(pack_dense_input(plan, vals),
                                    device=device)
                got = unpack_dense_output(plan, fn(x))
                want = plan.execute_numpy(vals)
                if not all(np.array_equal(g, w) for g, w in zip(got, want)):
                    fail(f"dense {coll}/{variant} on {label} counts: not "
                         "bitwise equal to execute_numpy")
                ms = time_ms(lambda: fn(x), on_card)
                rows.append(dict(collective=coll, variant=variant,
                                 counts=label, n=n, rounds=plan.n_rounds,
                                 ms=ms))
                log(f"dense {coll:14s} {variant:4s} {label:8s} n={n:>8d} "
                    f"rounds={plan.n_rounds:2d}: bitwise equal to "
                    f"execute_numpy, {ms:.4f} ms")
                del x, got
    return rows


# ------------------------------------------------------- calibrate phase
PROBE_N_PER = 16384                  # values a probe message: the reference
#                                      test's probe size
PROBE_N_PER_FINE = 65536             # the fine level's values a rank: a
#                                      second probe set, fitted apart
PROBE_STRATEGIES = ("standard", "partial", "full")
MEASURE_ITERS, MEASURE_WARMUP = 20, 3
RATE_FIELDS = ("alpha_intra", "beta_intra", "alpha_inter", "beta_inter",
               "region_injection_bw")
FIT_RMSE_GATE = 10.0                 # the reference's calibration gate
ORACLE_RTOL, ORACLE_RMSE = 1e-6, 1e-9
EXCITE_STEP = 1e-3                   # a rate this much dearer must slow a
#                                      probe for the probes to excite it
PLANTED_SCALE = 10.0                 # the planted fault: every time x 10
DECODE_TOKENS = 4                    # the serve phase's 4 slots
PREFILL_TOKENS = 4 * 512             # its worst-case prefill plan


def time_pattern(tracer, label: str, cache, pattern, topo, device,
                 strategy: str, params):
    """Time ``pattern``'s exchange (``PlanCache.executor``,
    ``time_executor`` in float64) and record it in ``tracer`` as a pure
    exchange; returns the sample."""
    import numpy as np

    from repro_torch.core import time_executor

    coll = cache.collective(pattern, topo, strategy, 8, params)
    fn = cache.executor(pattern, topo, device, strategy, 8, params)
    secs = time_executor(fn, topo.n_procs, int(pattern.n_local.max()),
                         np.float64, MEASURE_ITERS, MEASURE_WARMUP,
                         device=device)
    return tracer.record_plan(coll.plan, secs, label=label,
                              pure_exchange=True)


def probe_trace(cache, topo, device, n_per: int):
    """Every rate probe (``rate_probe_patterns`` x ``PROBE_STRATEGIES``)
    timed into one trace of pure exchanges."""
    from repro_torch.core.costmodel import LASSEN
    from repro_torch.profile import TraceRecorder, rate_probe_patterns

    tracer = TraceRecorder()
    for label, pattern in rate_probe_patterns(topo, n_per=n_per):
        for strategy in PROBE_STRATEGIES:
            time_pattern(tracer, f"probe/{n_per}/{label}/{strategy}", cache,
                         pattern, topo, device, strategy, LASSEN)
    return tracer


def fallbacks(params, ref) -> list:
    """The rates a fit took from ``ref`` (the samples did not excite them,
    or they fit to a zero rate): equal to the reference's bit for bit."""
    return [f for f in RATE_FIELDS
            if getattr(params, f) == getattr(ref, f)]


def log_fit(result, label: str) -> None:
    ref = result.ref
    log(f"{label}:\n{result.table()}")
    for f in RATE_FIELDS:
        a, b = float(getattr(ref, f)), float(getattr(result.params, f))
        log(f"  rate {f:20s} {ref.name} {a:.6g} fitted {b:.6g} "
            f"ratio {b / a:.6g}")
    log(f"  taken from {ref.name} (not excited, or fit to a zero rate): "
        f"{fallbacks(result.params, ref) or 'none'}")


def rounds_fit(tracer) -> dict:
    """Seconds of the trace's pure samples against their wire rounds (the
    ``color_rounds`` of every step), by least squares: on stacked ranks a
    round is a fixed run of eager ops, whatever it carries."""
    import numpy as np

    pure = [smp for smp in tracer.samples if smp.pure_exchange]
    rounds = np.array([sum(st.rounds for st in smp.steps) for smp in pure],
                      dtype=float)
    secs = np.array([smp.seconds for smp in pure])
    slope, fixed = np.polyfit(rounds, secs, 1)
    resid = secs - (slope * rounds + fixed)
    r2 = 1.0 - float(resid @ resid) / float(((secs - secs.mean()) ** 2).sum())
    return dict(per_round=float(slope), fixed=float(fixed), r2=r2)


def rel_off(got: float, want: float) -> float:
    """|got - want| / |want|; 0 if both are 0, inf if only ``want`` is."""
    if want == 0.0:
        return 0.0 if got == 0.0 else float("inf")
    return abs(got - want) / abs(want)


def probe_excited(plans, params) -> list:
    """The rates the plans' modeled times depend on at ``params``: making
    one EXCITE_STEP dearer (its alpha up, its bandwidth down) slows some
    plan.  A rate that no plan's bottleneck uses there is not identified
    by those plans: ``synthesize_trace`` promises a fit back only for the
    rates the plan set excites."""
    from repro_torch.core import plan_time

    base = [plan_time(p, params) for p in plans]
    out = []
    for f in RATE_FIELDS:
        v = getattr(params, f)
        dearer = dataclasses.replace(params, **{f: (
            v * (1.0 + EXCITE_STEP) if f.startswith("alpha")
            else v / (1.0 + EXCITE_STEP))})
        if any(plan_time(p, dearer) > t * (1.0 + 1e-9)
               for p, t in zip(plans, base)):
            out.append(f)
    return out


def check_fit_oracle(fitted, topo, n_per: int) -> dict:
    """The round trip at ``fitted``: a trace synthesized from the cost model
    under ``fitted`` over the probe plans fits back to it, every rate the
    probes excite there within ORACLE_RTOL and rel_rmse under ORACLE_RMSE,
    the bar the reference holds its own fit to.  A rate the probes do not
    excite at ``fitted`` (the injection cap, where the inter latency
    outweighs it in every probe) is printed, not held: any value of it
    gives the same probe times."""
    from repro_torch.core.costmodel import LASSEN
    from repro_torch.profile import fit_trace, probe_plans, synthesize_trace

    plans = probe_plans(topo, value_bytes=8, strategies=PROBE_STRATEGIES,
                        n_per=n_per)
    excited = probe_excited(plans, fitted)
    back = fit_trace(synthesize_trace(plans, fitted), ref=LASSEN)
    off = {f: rel_off(getattr(back.params, f), getattr(fitted, f))
           for f in RATE_FIELDS}
    worst = max((off[f] for f in excited), default=0.0)
    log(f"fit oracle: the trace synthesized at the fitted rates fits back "
        f"within {worst:.3e} on the {len(excited)} rates the probes excite "
        f"there (bar {ORACLE_RTOL:g}), rel_rmse {back.gof['rel_rmse']:.3e} "
        f"(bar {ORACLE_RMSE:g}); not excited: "
        + (", ".join(f"{f} (back {off[f]:.3e} off)" for f in RATE_FIELDS
                     if f not in excited) or "none"))
    if not (back.converged and len(excited) and worst <= ORACLE_RTOL
            and back.gof["rel_rmse"] < ORACLE_RMSE):
        fail(f"fit oracle: {back.params} from a trace synthesized at "
             f"{fitted}, gof {back.gof}, excited {excited}")
    return dict(worst_rel=worst, rel_rmse=back.gof["rel_rmse"],
                excited=excited)


def check_planted_fit(tracer, result) -> dict:
    """The planted fault: the measured trace with every time x
    PLANTED_SCALE must fit to scaled rates (alphas x 10, bandwidths / 10)
    and keep the reference's fallbacks as they are; a fit that returns the
    measured rates does not read the times."""
    from repro_torch.profile import TraceRecorder, fit_trace

    planted = TraceRecorder.from_json(tracer.to_json())
    for smp in planted.samples:
        smp.seconds *= PLANTED_SCALE
    got = fit_trace(planted, name="planted", ref=result.ref).params
    kept = fallbacks(result.params, result.ref)
    worst = 0.0
    for f in RATE_FIELDS:
        want = getattr(result.params, f)
        if f not in kept:
            want = (want * PLANTED_SCALE if f.startswith("alpha")
                    else want / PLANTED_SCALE)
        worst = max(worst, rel_off(getattr(got, f), want))
    if worst > ORACLE_RTOL or all(
            getattr(got, f) == getattr(result.params, f)
            for f in RATE_FIELDS):
        fail(f"planted x{PLANTED_SCALE:g} trace fit to {got}; measured fit "
             f"{result.params} (worst {worst:.3e})")
    log(f"planted fault (every time x{PLANTED_SCALE:g}): fits to the scaled "
        f"rates within {worst:.3e}, {len(kept)} fallbacks kept; the fit "
        "refuses a planted fault")
    return dict(worst_rel=worst)


# K1, K2 and K4: measure_spmv_seconds runs flat/off and blocked/off
CALIBRATE_KERNELS = ("spmv_ell", "spmv_ell_blocked", "spmv_ell_blocked_skip")


def card_figures(amg: dict) -> dict:
    """The card's own figures for the ``auto`` kernel and overlap rules:
    the flat kernel's x is read through L2, which the 8 stacked ranks
    share, so an eighth of this card's L2 is the flat footprint's limit;
    the data sheet's memory rate and float64 rate; and the median host
    time of one K1-K4 call in this run's kernel records as the launch
    cost."""
    import statistics

    import torch

    props = torch.cuda.get_device_properties(0)
    return dict(
        vmem_limit=props.L2_cache_size // N_PROCS,
        hbm_bw=PEAK_BYTES_PER_S, vpu_flops=PEAK_FLOPS["float64"],
        launch_s=statistics.median(
            amg["kernels"][k]["host_us"] for k in REPLACES) * 1e-6)


def calibrate_phase(amg: dict, part: dict, figures: dict, out_dir,
                    n_per: int = PROBE_N_PER,
                    n_per_fine: int = PROBE_N_PER_FINE,
                    serve_cfg=None) -> dict:
    """Measure, fit and re-select, then solve under the fit.

    ``amg`` is :func:`run`'s result (the host hierarchy, vector and
    history), ``part`` :func:`partitioned_run`'s (the set-up's exchange
    records and the coarsest counts).  One trace takes the rate probes at
    ``n_per`` values, the paper problem's exchanges (blocked/off), its
    SpMVs (flat/off and blocked/off; impure, out of the fit), the dense
    plans on the coarsest counts and the set-up's ``gather_A`` /
    ``gather_P`` patterns; ``fit_trace`` under ``LASSEN`` must pass the
    reference's gate, the round trip and the planted fault.  A second
    probe set at ``n_per_fine`` is fitted apart.  Then the selections
    under ``LASSEN`` against the fit (AMG levels, the MoE modes of
    ``serve_cfg``, default the served DeepSeek, and ``coarse_gather``), and
    a solve with every ``auto`` under the fit and ``figures``
    (``vmem_limit``, ``hbm_bw``, ``vpu_flops``, ``launch_s``) against the
    host history.  The trace and the fitted params go to ``out_dir``
    before the gate."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.amg import DistributedHierarchy
    from repro_torch.core import (
        DENSE_COLLECTIVES,
        PlanCache,
        Topology,
        build_dense_plan,
        dense_variants,
        measure_dense_seconds,
    )
    from repro_torch.core.costmodel import LASSEN, plan_time
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import Mesh, Model, serving
    from repro_torch.profile import fit_trace, selection_flips
    from repro_torch.sparse.device import select_spmv_overlap

    host = amg["host"]
    h, b, device = host["h"], host["b"], host["device"]
    on_card = device == "cuda"
    topo = Topology(N_PROCS, PROCS_PER_REGION)
    cache = PlanCache()
    before = dict(LAUNCHES)
    t_phase = time.perf_counter()

    # 1. the rate probes
    tracer = probe_trace(cache, topo, device, n_per)
    log(f"calibrate: {len(tracer.samples)} probes at {n_per} values a "
        f"message timed (time_executor, float64, {MEASURE_ITERS} calls "
        f"after 1 + {MEASURE_WARMUP})")

    # 2. the paper problem: exchanges, SpMVs, dense plans, set-up gathers
    lowered = {}
    for variant in ("flat", "blocked"):
        t0 = time.perf_counter()
        lowered[variant] = DistributedHierarchy.setup(
            h, N_PROCS, procs_per_region=PROCS_PER_REGION, strategy="auto",
            params=LASSEN, cache=cache, spmv_variant=variant,
            spmv_overlap="off", spmv_block_cols=host["block_cols"],
            device=device)
        log(f"calibrate: {variant}/off lowering "
            f"{time.perf_counter() - t0:.2f} s")
    exchange = lowered["blocked"].measure_exchange_seconds(
        MEASURE_ITERS, MEASURE_WARMUP, tracer=tracer)
    spmv = {}
    for variant, dh in lowered.items():
        start = dict(LAUNCHES)
        spmv[variant] = dh.measure_spmv_seconds(tracer=tracer)
        got = {k: LAUNCHES[k] - start[k] for k in REPLACES
               if LAUNCHES[k] - start[k]}
        log(f"calibrate: measure_spmv_seconds {variant}/off launched {got}")
    dense = []
    counts = np.asarray(part["coarse_counts"], dtype=np.int64)
    for coll in DENSE_COLLECTIVES:
        for variant in dense_variants(coll, topo):
            plan = build_dense_plan(coll, counts, topo, variant)
            secs = measure_dense_seconds(plan, device, iters=MEASURE_ITERS,
                                         warmup=MEASURE_WARMUP,
                                         tracer=tracer)
            dense.append((plan.strategy, secs))
    gathers = []
    for rec in part["partitioned"]["setup_records"]:
        if rec.phase not in ("gather_A", "gather_P") or rec.pattern is None \
                or rec.pattern.total_ghosts() == 0:
            continue
        smp = time_pattern(tracer, f"setup/L{rec.level}/{rec.phase}", cache,
                           rec.pattern, topo, device, "auto", LASSEN)
        gathers.append((f"L{rec.level}/{rec.phase}", smp.strategy,
                        smp.seconds))
    where = "" if on_card else " (the CPU: a rehearsal, not a measurement)"
    log(f"calibrate: per-level ms{where}: level, strategy, exchange "
        "(blocked/off), SpMV flat/off, SpMV blocked/off")
    for (k, strat, ex_s), f_row, b_row in zip(exchange, spmv["flat"],
                                              spmv["blocked"]):
        log(f"  L{k:<2d} {strat:8s} {ex_s * 1e3:9.4f} {f_row[3] * 1e3:9.4f} "
            f"{b_row[3] * 1e3:9.4f}")
    log("calibrate: dense ms on the coarsest counts: " + ", ".join(
        f"{name} {secs * 1e3:.4f}" for name, secs in dense))
    log(f"calibrate: {len(gathers)} set-up gathers, ms: " + ", ".join(
        f"{name} {strat} {secs * 1e3:.4f}" for name, strat, secs in gathers))

    # 3. the fit, saved before its gate (the reference's)
    result = fit_trace(tracer, name="fitted-h100", ref=LASSEN)
    summary = tracer.summary()
    log(f"calibrate: trace {summary}; {result.n_samples} merged pure "
        "samples enter the fit")
    log_fit(result, f"fitted on {device} (rates in s and B/s)")
    out_dir.mkdir(parents=True, exist_ok=True)
    tracer.save(out_dir / "trace.json")
    result.save(out_dir / "fitted_params.json")
    gof = result.gof
    if not result.converged or not np.isfinite(gof["rel_rmse"]) \
            or gof["rel_rmse"] > FIT_RMSE_GATE:
        fail(f"calibration fit did not converge: converged="
             f"{result.converged} gof={gof}")
    fitted = result.params
    per_round = rounds_fit(tracer)
    log(f"calibrate: the pure samples against their rounds (least squares, "
        f"not a model the selectors use): {per_round['per_round'] * 1e6:.1f}"
        f" us a round + {per_round['fixed'] * 1e6:.1f} us, r2 "
        f"{per_round['r2']:.3f}")
    fine = fit_trace(probe_trace(cache, topo, device, n_per_fine),
                     name=f"fitted-h100-probes-{n_per_fine}", ref=LASSEN)
    log_fit(fine, f"the probes alone at {n_per_fine} values a message, "
            "fitted apart (not used below)")

    # 4. the fit against its oracle and a planted fault
    oracle = check_fit_oracle(fitted, topo, n_per)
    planted = check_planted_fit(tracer, result)

    # 5. re-select under LASSEN and under the fit
    labeled = [(f"L{lv.index}", lv.A.part.pattern)
               for lv in lowered["blocked"].levels]
    flips = selection_flips(labeled, topo, LASSEN, fitted, value_bytes=8)
    cfg = serve_cfg or configs.get(SERVE_ARCH)
    moe = {}
    for label, n_tokens in (("decode", DECODE_TOKENS),
                            ("prefill", PREFILL_TOKENS)):
        moe[label] = {}
        for params in (LASSEN, fitted):
            model = Model(cfg, mesh=Mesh(*SERVE_MESH), moe_mode="auto",
                          machine_params=params, device=device)
            moe[label][params.name] = serving.moe_plan_for_model(
                model, n_tokens, cache=PlanCache()).mode
    coarse = {params.name: cache.dense_collective(
        "allgatherv", counts, topo, "auto", 8, params)[1].chosen
        for params in (LASSEN, fitted)}
    n_flips = (sum(r["flip"] == "yes" for r in flips)
               + sum(len(set(m.values())) > 1 for m in moe.values())
               + (len(set(coarse.values())) > 1))
    log(f"calibrate: selections under {LASSEN.name} -> {fitted.name}:")
    for r in flips:
        log(f"  {r['label']:4s} {r['shipped']:8s} -> {r['fitted']:8s} "
            f"flip {r['flip']}")
    for label, m in moe.items():
        log(f"  MoE {label} ({cfg.name}, {SERVE_MESH[1]} lanes): "
            f"{m[LASSEN.name]} -> {m[fitted.name]}")
    log(f"  coarse_gather auto ({len(counts)} segments): "
        f"{coarse[LASSEN.name]} -> {coarse[fitted.name]}")
    log(f"calibrate: {n_flips} flips")

    # 6. every auto under the fit and the card's own figures
    overlap_figures = {k: figures[k]
                       for k in ("hbm_bw", "vpu_flops", "launch_s")}
    t0 = time.perf_counter()
    dh = DistributedHierarchy.setup(
        h, N_PROCS, procs_per_region=PROCS_PER_REGION, strategy="auto",
        params=fitted, cache=cache, spmv_variant="auto",
        spmv_vmem_limit=figures["vmem_limit"],
        spmv_block_cols=host["block_cols"], spmv_overlap="auto",
        spmv_overlap_figures=overlap_figures, coarse_gather="auto",
        device=device)
    setup_s = time.perf_counter() - t0
    v_cycles = host["v_cycles"]
    dh.solve(b, tol=0.0, max_iters=1)               # warm-up V-cycle
    start = dict(LAUNCHES)
    card_sync(on_card)
    t0 = time.perf_counter()
    _, hist = dh.solve(b, tol=0.0, max_iters=v_cycles)
    card_sync(on_card)
    ms = (time.perf_counter() - t0) * 1e3 / v_cycles
    host_hist = host["hist"]
    dev = float(np.max(np.abs(np.asarray(hist) - np.asarray(host_hist))
                       / np.maximum(np.abs(host_hist), 1e-300)))
    per_cycle = {k: (LAUNCHES[k] - start[k]) / v_cycles for k in REPLACES
                 if LAUNCHES[k] - start[k]}
    log(f"calibrate: solve with every auto under {fitted.name} and "
        f"{figures}: set-up {setup_s:.2f} s, {ms:.3f} ms per V-cycle, max "
        f"rel history deviation {dev:.3e}, launches per V-cycle "
        f"{per_cycle}; {dh.coarse_selection}")
    if not (len(hist) == len(host_hist) and np.allclose(
            hist, host_hist, rtol=HIST_RTOL, atol=HIST_ATOL)):
        fail(f"calibrate solve: history {hist} vs host {host_hist}")

    rows, agree = [], 0
    log(f"calibrate: per level, A's strategy / kernel / overlap under "
        f"{LASSEN.name} auto | under the fit and the card's figures | the "
        "faster measured SpMV (flat/off against blocked/off)")
    for lv, lv_l, f_row, b_row, flip in zip(
            dh.levels, lowered["blocked"].levels, spmv["flat"],
            spmv["blocked"], flips):
        if lv.A.strategy != flip["fitted"]:
            fail(f"calibrate L{lv.index}: the solve chose {lv.A.strategy}, "
                 f"selection_flips {flip['fitted']}")
        ov_l = select_spmv_overlap(
            lv_l.A.part, plan_time(lv_l.A.coll.plan, LASSEN), mode="auto",
            **overlap_figures).mode
        faster = "flat" if f_row[3] <= b_row[3] else "blocked"
        agree += lv.A.kernel_variant == faster
        rows.append(dict(
            level=lv.index,
            lassen=(lv_l.A.strategy, lv.A.kernel_variant, ov_l),
            fitted=(lv.A.strategy, lv.A.kernel_variant, lv.A.overlap_mode),
            measured_faster=faster))
        log(f"  L{lv.index:<2d} {lv_l.A.strategy:8s} "
            f"{lv.A.kernel_variant:7s} {ov_l:3s} | {lv.A.strategy:8s} "
            f"{lv.A.kernel_variant:7s} {lv.A.overlap_mode:3s} | {faster:7s}"
            f" (flat {f_row[3] * 1e3:.4f} ms, blocked "
            f"{b_row[3] * 1e3:.4f} ms)")
    log(f"calibrate: the flat-vs-blocked rule agrees with the faster "
        f"measured SpMV on {agree} of {len(rows)} levels")
    launches = {k: LAUNCHES[k] - before[k] for k in REPLACES}
    log(f"calibrate phase {time.perf_counter() - t_phase:.1f} s; K1-K4 "
        f"launches in it {launches}")
    return dict(params=fitted, gof=gof, fine=fine.params, oracle=oracle,
                per_round=per_round,
                planted=planted, flips=flips, moe=moe, coarse=coarse,
                n_flips=n_flips, exchange=exchange, spmv=spmv, dense=dense,
                gathers=gathers, levels=rows, rule_agrees=agree,
                max_rel_dev=dev, ms_per_vcycle=ms, launches=launches,
                summary=summary)


# ------------------------------------------------------------- serve phase
SERVE_ARCH = "deepseek-v2-lite-16b"
SERVE_MESH = (("pod", "model"), (2, 4))    # 8 EP lanes, the AMG's 2 x 4
SERVE_MODES = ("a2a", "hier", "hier_dedup", "auto")
# the modes whose kernel calls the kernel phase records and the oracle
# replays (``auto`` chooses between them; the planted faults run on the
# first)
ORACLE_MODES = ("a2a", "hier_dedup")
SERVE_SEED = 0
AMPLE_CAP = 8.0                 # no capacity drops: every mode is one function
# logits: max |kernel - plain| <= LOGIT_TOL * max |plain| per call, in bf16
# (a few bf16 roundings, 2^-8 each, that differ between the two through 27
# layers); greedy tokens must agree on every row whose top-2 margin exceeds
# that absolute tolerance
LOGIT_TOL = 2 ** -5
# one kernel call against its plain version, normwise: bf16 allows one
# rounding of the output (2^-8 relative) on either side
SERVE_TOL = {"bfloat16": 2 ** -7, "float32": 1e-5}
# K8 against its plain version, normwise: float32 at the reference's own
# kernel tolerance (tests/test_kernel_ssd.py), bf16 as SERVE_TOL
SSD_TOL = {"bfloat16": 2 ** -7, "float32": 1e-4}
SSD_CHUNK = 128                 # the reference kernel's chunk
# The bf16 K7 prefill and K8 carry each fp32 operand of a tensor-core
# product (K7's P; K8's M, S and w x) as bf16 hi + lo, to about 2^-17
# (csrc/tile_mma.cuh).  Seen on a call's bf16 outputs: the share of them
# that are not the correctly rounded float64 value.  Emulated on the CPU
# (random bf16 inputs at the path's shapes), hi + lo misrounds some 0.2 %
# and one bf16 rounding of those operands (the control) 30-38 %.
SPLIT_SHARE = 0.02
SERVE_SOURCES = {
    "gather_rows": ("src/repro_torch/csrc/moe_pack.cu",
                    "src/repro/kernels/moe_pack/moe_pack.py:39"),
    "combine_rows": ("src/repro_torch/csrc/moe_pack.cu",
                     "src/repro/kernels/moe_pack/moe_pack.py:79"),
    "flash_attention_bh": (
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:96"),
}


def serve_sizes(on_card: bool) -> dict:
    """Slots, cache length and requests (prompt lengths, tokens to
    generate); six requests on four slots, so slots are recycled and the
    batch re-prefilled.  Off the card, the CPU rehearsal's tiny sizes."""
    if on_card:
        return dict(slots=4, max_len=512,
                    prompts=(100, 400, 250, 330, 180, 120),
                    new=(16, 32, 24, 20, 28, 16))
    return dict(slots=4, max_len=32, prompts=(5, 12, 9, 7, 3, 6),
                new=(3, 4, 2, 3, 4, 2))


def serve_requests(vocab: int, sizes: dict) -> list:
    import numpy as np

    from repro_torch.serve import Request

    rng = np.random.default_rng(SERVE_SEED)
    return [Request(rid=i, prompt=rng.integers(0, vocab, size=(n,)).astype(
        np.int32), max_new_tokens=m)
        for i, (n, m) in enumerate(zip(sizes["prompts"], sizes["new"]))]


def warm_up(model, params, sizes: dict) -> None:
    """Library handles and first launches: one short request, untimed."""
    from repro_torch.serve import ServeEngine

    warm = ServeEngine(model, params, batch_slots=sizes["slots"],
                       max_len=sizes["max_len"])
    warm.submit(serve_requests(model.cfg.vocab, dict(sizes, prompts=(16,),
                                                     new=(2,)))[0])
    warm.run_until_drained()


def check_served(done: list, sizes: dict, vocab: int, label: str) -> None:
    """Every request came back with its tokens, each a vocabulary id."""
    if len(done) != len(sizes["prompts"]) or any(
            len(r.generated) != n or not all(0 <= t < vocab
                                             for t in r.generated)
            for r, n in zip(sorted(done, key=lambda r: r.rid),
                            sizes["new"])):
        fail(f"{label}: requests not served in full")


def card_sync(on_card: bool) -> None:
    import torch

    if on_card:
        torch.cuda.synchronize()


# the served models' kernel call sites: binding name -> (module of
# repro_torch.models, attribute).  K6's takes the lane form, buf [G, R, D]
# and idx / w [G, N, K] (``combine_lanes``).
CALL_SITES = {"gather": ("moe", "pack_gather"),
              "combine": ("moe", "pack_combine_lanes"),
              "flash": ("attention", "flash"), "ssd": ("ssm", "ssd")}
@contextlib.contextmanager
def bound_kernels(**fns):
    """Bind the served models' kernel call sites named in ``fns`` (K5
    ``gather``, K6 ``combine``, K7 ``flash``, K8 ``ssd``; see
    ``CALL_SITES``) to the given functions while the block runs."""
    import importlib

    sites = {k: (importlib.import_module(f"repro_torch.models.{mod}"), attr)
             for k, (mod, attr) in CALL_SITES.items() if k in fns}
    saved = {k: getattr(mod, attr) for k, (mod, attr) in sites.items()}
    for k, (mod, attr) in sites.items():
        setattr(mod, attr, fns[k])
    try:
        yield
    finally:
        for k, (mod, attr) in sites.items():
            setattr(mod, attr, saved[k])


def plain_kernels():
    """The models bound to the plain versions of K5-K8: their oracle."""
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.moe_pack import combine_lanes_ref, gather_rows_ref
    from repro_torch.kernels.ssd_scan import ssd_scan_ref

    return bound_kernels(gather=gather_rows_ref, combine=combine_lanes_ref,
                         flash=attention_ref, ssd=ssd_scan_ref)


def planted_faults() -> dict:
    """The model bound to its kernels with one fault planted in each
    binding: the oracle must catch every one of them."""
    import torch

    from repro_torch.kernels.flash_attention import attention
    from repro_torch.kernels.flash_attention.ref import (
        DECODE_SPLIT,
        decode_splits,
    )
    from repro_torch.kernels.moe_pack import combine_lanes as combine

    def k6_drops_last_weight(buf, idx, w):
        return combine(buf, idx, torch.cat(
            [w[..., :-1], torch.zeros_like(w[..., -1:])], dim=-1))

    def k6_reads_lane_0(buf, idx, w):
        """Every lane's indices read lane 0's rows: the lane offset
        dropped."""
        G, N, K = idx.shape
        return combine(buf[:1], idx.reshape(1, G * N, K),
                       w.reshape(1, G * N, K)).reshape(G, N, -1)

    def k7_ignores_q_offset(q, k, v, **kw):
        return attention(q, k, v, **dict(kw, q_offset=0))

    def k7_drops_last_split(q, k, v, **kw):
        """A one-row call whose combine leaves out its last key split: the
        keys of that split masked (with one split, every key)."""
        if q.shape[2] != 1:
            return attention(q, k, v, **kw)
        Tk = k.shape[2]
        kv_len = kw.get("kv_len")
        begin, _, n = decode_splits(
            Tk, Tk if kv_len is None else kv_len, kw.get("causal", True),
            kw.get("window", 0), kw.get("q_offset", 0))
        return attention(q, k, v, **dict(
            kw, kv_len=begin + (n - 1) * DECODE_SPLIT))

    faults = {
        "K6 drops the last of its K weights": bound_kernels(
            combine=k6_drops_last_weight),
        "K6 reads every lane's rows from lane 0": bound_kernels(
            combine=k6_reads_lane_0),
        "K7 ignores q_offset": bound_kernels(flash=k7_ignores_q_offset),
        "K7's decode combine drops its last key split": bound_kernels(
            flash=k7_drops_last_split),
    }
    return faults


@contextlib.contextmanager
def recording_serve_kernel_calls(calls: dict, phase: str):
    """Record the K5-K8 calls the served path makes while the block runs:
    ``calls[(kernel, phase, shape key)] = [calls, [arguments of each
    call]]``.  The calls still go through to the ops."""
    import torch

    from repro_torch.models import attention, moe, ssm

    def key(name, a):
        return (name, phase) + tuple(
            (k, tuple(v.shape), str(v.dtype)) if torch.is_tensor(v) else (k, v)
            for k, v in sorted(a.items()))

    def record(name, a):
        entry = calls.setdefault(key(name, a), [0, []])
        entry[0] += 1
        entry[1].append(a)

    def pack(x, idx):
        record("gather_rows", dict(x=x, idx=idx))
        return saved["pack_gather"](x, idx)

    def combine(buf, idx, w):
        record("combine_rows", dict(buf=buf, idx=idx, w=w))
        return saved["pack_combine_lanes"](buf, idx, w)

    def flash(q, k, v, **kw):
        B, H, Tq, d = q.shape
        Tk = k.shape[2]
        kv_len, scale = kw.get("kv_len"), kw.get("scale")
        record("flash_attention_bh", dict(
            q=q.reshape(B * H, Tq, d), k=k.reshape(B * H, Tk, d),
            v=v.reshape(B * H, Tk, d),
            scale=float(d ** -0.5 if scale is None else scale),
            causal=bool(kw.get("causal", True)),
            window=int(kw.get("window", 0)),
            kv_len=int(Tk if kv_len is None else kv_len),
            q_offset=int(kw.get("q_offset", 0))))
        return saved["flash"](q, k, v, **kw)

    def ssd(x, dt, A, B, C, **kw):
        record("ssd_scan_h", dict(x=x, dt=dt, A=A, B=B, C=C))
        return saved["ssd"](x, dt, A, B, C, **kw)

    saved = dict(pack_gather=moe.pack_gather,
                 pack_combine_lanes=moe.pack_combine_lanes,
                 flash=attention.flash, ssd=ssm.ssd)
    with bound_kernels(gather=pack, combine=combine, flash=flash, ssd=ssd):
        yield calls


def recording_engine(engine, on_card: bool, kernel_calls=None) -> list:
    """Wrap the engine's prefill and decode so that each call's inputs,
    logits (on the host), seconds and kernel launches are recorded; with
    ``kernel_calls``, also the K5-K7 calls of the first prefill and the
    first decode step."""
    from repro_torch.kernels import CUDA_LAUNCHES, LAUNCHES

    calls: list = []
    prefill, decode = engine._prefill, engine._decode

    def run(kind, fn, args, rec):
        first = kernel_calls is not None and not any(
            c["kind"] == kind for c in calls)
        card_sync(on_card)
        before, before_cuda = dict(LAUNCHES), dict(CUDA_LAUNCHES)
        t0 = time.perf_counter()
        with (recording_serve_kernel_calls(kernel_calls, kind) if first
              else contextlib.nullcontext()):
            logits, caches = fn(*args)
            card_sync(on_card)
        rec.update(kind=kind, s=time.perf_counter() - t0,
                   logits=logits.float().cpu(),
                   launches={k: LAUNCHES[k] - before[k] for k in LAUNCHES},
                   cuda_launches={k: CUDA_LAUNCHES[k] - before_cuda[k]
                                  for k in CUDA_LAUNCHES})
        calls.append(rec)
        return logits, caches

    engine._prefill = lambda p, i: run(
        "prefill", prefill, (p, i), dict(tokens=i["tokens"].cpu()))
    engine._decode = lambda p, i, c, n: run(
        "decode", decode, (p, i, c, n), dict(tokens=i["tokens"].cpu(),
                                             cur_len=int(n)))
    return calls


def serve_summary(calls: list, kernels=tuple(SERVE_SOURCES)) -> dict:
    """Prefill tokens/s, ms per decode step, and calls and CUDA launches
    per engine call of ``kernels``, over the recorded engine calls."""
    pre = [c for c in calls if c["kind"] == "prefill"]
    dec = [c for c in calls if c["kind"] == "decode"]
    out = dict(
        prefills=len(pre), decode_steps=len(dec),
        prefill_tokens=sum(c["tokens"].numel() for c in pre),
        prefill_s=sum(c["s"] for c in pre),
        decode_ms=1e3 * sum(c["s"] for c in dec) / max(1, len(dec)),
    )
    out["prefill_tok_s"] = out["prefill_tokens"] / max(out["prefill_s"],
                                                       1e-12)
    for tag, group in (("prefill", pre), ("decode", dec)):
        for count in ("launches", "cuda_launches"):
            out[f"{count}_per_{tag}"] = {
                k: sum(c[count][k] for c in group) / max(1, len(group))
                for k in kernels}
    return out


@contextlib.contextmanager
def routing(decisions: list, replay: bool):
    """Record the MoE router's decisions (``moe.route``'s expert ids,
    weights and aux loss, call by call) while the block runs, or replay
    recorded ones in the same order.  Replaying still runs the router and
    counts the (lane, token) rows whose own expert ids differ from the
    recorded ones."""
    from repro_torch.models import moe

    real = moe.route
    stats = {"rows": 0, "flipped": 0}
    recorded = iter(decisions)

    def record(x, router_w, plan):
        out = real(x, router_w, plan)
        decisions.append(out)
        return out

    def forced(x, router_w, plan):
        own, rec = real(x, router_w, plan), next(recorded)
        if own[0].shape != rec[0].shape:
            fail(f"routing replay: {tuple(own[0].shape)} vs "
                 f"{tuple(rec[0].shape)}")
        stats["rows"] += own[0].numel() // own[0].shape[-1]
        stats["flipped"] += int((own[0] != rec[0]).any(-1).sum())
        return rec

    moe.route = forced if replay else record
    try:
        yield stats
    finally:
        moe.route = real


def forward_rows(model, params, tokens) -> "torch.Tensor":
    """``model.forward``'s logits at every position of ``tokens`` [B, T],
    as [B * T, V] float32 rows on the host."""
    logits, _ = model.forward(params, {"tokens": tokens.to(model.device)})
    return logits.float().reshape(-1, logits.shape[-1]).cpu()


def replay(model, params, engine, calls: list, decisions: list,
           binding) -> tuple:
    """The recorded engine calls again, with the same inputs and the same
    routing decisions, under ``binding`` (a :func:`bound_kernels`); returns
    their logits on the host and the routing flips.

    The routing is replayed because it is discrete: a bf16 rounding that
    differs between a kernel and its plain version moves a router input by
    an ulp, which can swap a token's 6th and 7th expert, and the swap
    changes that token's output by a whole expert's share.  Replayed, a
    comparison measures the kernels; the swaps are counted."""
    from repro_torch.models import serving

    dev = model.device
    out, caches = [], None
    with binding, routing(decisions, replay=True) as flips:
        for c in calls:
            toks = {"tokens": c["tokens"].to(dev)}
            if c["kind"] == "prefill":
                logits, caches = serving.prefill(
                    model, params, toks, max_len=engine.max_len,
                    moe_plan=engine.moe_prefill_plan)
            else:
                logits, caches = serving.decode_step(model, params, toks,
                                                     caches, c["cur_len"])
            out.append(logits.float().cpu())
    return out, flips


def compare_logits(got: list, want: list, tol: float = LOGIT_TOL) -> dict:
    """Call by call: the largest ``max |got - want| / max |want|``, and the
    rows whose greedy tokens differ among those whose top-2 margin in
    ``got`` exceeds ``tol`` of the largest logit."""
    import torch

    worst, rows, sure_rows, differ = 0.0, 0, 0, 0
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        worst = max(worst, float((g - w).abs().max()) / max(scale, 1e-30))
        top2 = torch.topk(g, 2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > tol * scale
        same = torch.argmax(g, -1) == torch.argmax(w, -1)
        rows += g.shape[0]
        sure_rows += int(sure.sum())
        differ += int((sure & ~same).sum())
    return dict(rel_err=worst, rows=rows, sure=sure_rows, differ=differ)


def replay_plain(model, params, engine, calls: list, decisions: list,
                 on_card: bool, faults=None, tol: float = LOGIT_TOL) -> dict:
    """The oracle: the recorded engine calls replayed (:func:`replay`)
    through the plain versions of the kernels on the same device; the
    kernel run's logits held to them within ``tol``, greedy tokens equal on
    every row whose top-2 margin exceeds it.  ``faults`` (name ->
    binding): the calls are replayed once more under each planted fault,
    and the oracle must refuse every one."""
    import torch

    plain, flips = replay(model, params, engine, calls, decisions,
                          plain_kernels())
    got = [c["logits"] for c in calls]
    if not all(bool(torch.isfinite(lg).all()) for lg in got + plain):
        fail("plain-version oracle: non-finite logits")
    res = compare_logits(got, plain, tol)
    if not res["rel_err"] <= tol:
        fail(f"plain-version oracle: logits differ by {res['rel_err']:.3e} "
             f"of their max, above {tol}")
    if res["differ"]:
        fail(f"plain-version oracle: greedy tokens differ on {res['differ']} "
             "rows with a clear top-2 margin")
    out = dict(oracle_rel_err=res["rel_err"], oracle_rows=res["rows"],
               oracle_sure=res["sure"], route_rows=flips["rows"],
               route_flips=flips["flipped"], planted={})
    for name, binding in (faults or {}).items():
        bad, _ = replay(model, params, engine, calls, decisions, binding)
        got = compare_logits(bad, plain, tol)
        out["planted"][name] = got
        if got["rel_err"] <= tol and not got["differ"]:
            fail(f"the oracle misses a planted fault ({name}): logits within "
                 f"{got['rel_err']:.3e}, greedy tokens equal")
    card_sync(on_card)
    return out


def serve_work(name: str, a: dict):
    """(bytes, flops) a K5-K8 call must move and do: each input read once,
    the output written once, counting only what this call's data needs
    (K6 the distinct real rows its indices read, none for a sentinel, and
    a product for each real index, K7 the keys below kv_len and
    the visible (query, key) pairs, K8 its true T in chunks of the
    reference's 128, the last one ragged)."""
    import torch

    if name == "ssd_scan_h":
        x, B = a["x"], a["B"]
        Bt, T, H, P = x.shape
        N = B.shape[3]
        nbytes = (2 * x.numel() * x.element_size()
                  + 2 * B.numel() * B.element_size()
                  + (a["dt"].numel() + a["A"].numel()) * 4)
        flops = sum(2 * L * L * (N + P) + 4 * L * N * P
                    for L in (min(SSD_CHUNK, T - t0)
                              for t0 in range(0, T, SSD_CHUNK)))
        return nbytes, Bt * H * flops

    if name == "gather_rows":
        x, idx = a["x"], a["idx"]
        row = x.shape[1] * x.element_size()
        rows = int(torch.unique(idx).numel())
        return rows * row + idx.numel() * (4 + row), 0
    if name == "combine_rows":
        buf, idx = a["buf"], a["idx"]
        D = buf.shape[2]
        row = D * buf.element_size()
        flat, real = k6_rows(a)
        rows = int(torch.unique(flat[real]).numel())
        tokens = idx.shape[0] * idx.shape[1]
        return (rows * row + idx.numel() * 8 + tokens * row,
                2 * int(real.sum()) * D)
    from repro_torch.kernels.flash_attention.ref import attention_mask

    q, k = a["q"], a["k"]
    BH, Tq, d = q.shape
    es = q.element_size()
    keys = min(a["kv_len"], k.shape[1])
    pairs = int(attention_mask(Tq, k.shape[1], a["causal"], a["window"],
                               a["kv_len"], a["q_offset"], q.device).sum())
    return (2 * BH * Tq * d * es + 2 * BH * keys * d * es,
            4 * BH * pairs * d)


def serve_kernel_call(name: str, a: dict):
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.moe_pack import ops as mp_ops
    from repro_torch.kernels.ssd_scan import ssd

    if name == "ssd_scan_h":
        return ssd(a["x"], a["dt"], a["A"], a["B"], a["C"])
    if name == "gather_rows":
        return mp_ops.pack(a["x"], a["idx"])
    if name == "combine_rows":
        return mp_ops.combine_lanes(a["buf"], a["idx"], a["w"])
    return fa_ops.flash_attention_bh(
        a["q"], a["k"], a["v"], scale=a["scale"], causal=a["causal"],
        window=a["window"], kv_len=a["kv_len"], q_offset=a["q_offset"])


def serve_plain_call(name: str, a: dict, operand=None):
    """The plain version of the call; ``operand`` as K7's and K8's plain
    versions take it (applied to their fp32 product operands)."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_bh_ref
    from repro_torch.kernels.moe_pack.ref import (
        combine_lanes_ref,
        gather_rows_ref,
    )
    from repro_torch.kernels.ssd_scan import ssd_scan_ref

    if name == "ssd_scan_h":
        return ssd_scan_ref(a["x"], a["dt"], a["A"], a["B"], a["C"],
                            operand=operand)
    if name == "gather_rows":
        return gather_rows_ref(a["x"], a["idx"])
    if name == "combine_rows":
        return combine_lanes_ref(a["buf"], a["idx"], a["w"])
    return flash_attention_bh_ref(
        a["q"], a["k"], a["v"], scale=a["scale"], causal=a["causal"],
        window=a["window"], kv_len=a["kv_len"], q_offset=a["q_offset"],
        operand=operand)


def serve_library_call(name: str, a: dict):
    """One PyTorch call computing the same function, as a yardstick only:
    ``index_select`` for K5, ``embedding_bag(mode="sum",
    per_sample_weights=...)`` for K6, ``scaled_dot_product_attention``
    with the explicit mask for K7; None for K8, since no single PyTorch
    call computes an SSD scan.

    K6's is built before the call: the bags are the lane-offset indices
    into buf seen as one [G * R, D] table, each sentinel mapped to the
    first row no real index reads, which is passed as ``padding_idx`` (so
    it adds nothing, as the sentinel adds nothing), and the weights are
    rounded to buf's dtype; None if every row is read (the timed calls'
    cold copies keep one such row: :func:`k6_compact`)."""
    import torch
    import torch.nn.functional as tf

    from repro_torch.kernels.flash_attention.ref import attention_mask

    if name == "ssd_scan_h":
        return None
    if name == "gather_rows":
        return lambda: torch.index_select(a["x"], 0, a["idx"])
    if name == "combine_rows":
        buf, K = a["buf"], a["idx"].shape[2]
        table = buf.reshape(-1, buf.shape[2])
        flat, real = k6_rows(a)
        read = torch.zeros(table.shape[0], dtype=torch.bool,
                           device=table.device)
        read[flat[real]] = True
        free = torch.nonzero(~read)
        if not free.numel():
            return None
        pad = int(free[0, 0])
        bags = torch.where(real, flat, pad).reshape(-1, K)
        w = a["w"].to(buf.dtype).reshape(-1, K)
        return lambda: tf.embedding_bag(bags, table, mode="sum",
                                        per_sample_weights=w,
                                        padding_idx=pad)
    q, k, v = a["q"], a["k"], a["v"]
    mask = attention_mask(q.shape[1], k.shape[1], a["causal"], a["window"],
                          a["kv_len"], a["q_offset"], q.device)
    return lambda: tf.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                   scale=a["scale"])


def serve_cast(a: dict, dtype) -> dict:
    """The call with its row tables / q, k, v / x, B, C in ``dtype`` (K6's
    weights and K8's dt and A stay float32)."""
    import torch

    return {k: v.to(dtype) if torch.is_tensor(v) and v.is_floating_point()
            and k not in ("w", "dt", "A") else v for k, v in a.items()}


def check_serve_call(name: str, a: dict, label: str) -> float:
    """The kernel against its plain version in bf16 and float32 (normwise
    ``SERVE_TOL``, K8 ``SSD_TOL``; K5 exactly); returns the bf16 max
    |difference|."""
    import torch

    abs_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        ad = serve_cast(a, dtype)
        got, want = serve_kernel_call(name, ad), serve_plain_call(name, ad)
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"{name} {label} {dname}: {tuple(got.shape)} {got.dtype} vs "
                 f"{tuple(want.shape)} {want.dtype}")
        if not bool(torch.isfinite(got).all()):
            fail(f"{name} {label} {dname}: non-finite output")
        err = rel_err(got.float(), want.float())
        tol = (0.0 if name == "gather_rows" else SSD_TOL[dname]
               if name == "ssd_scan_h" else SERVE_TOL[dname])
        if not err <= tol:
            fail(f"{name} {label} {dname}: max rel error {err} > {tol}")
        if dtype == torch.bfloat16 and got.numel():
            abs_err = float(torch.max(torch.abs(got.float() - want.float())))
    return abs_err


def misrounded_share(got, exact) -> float:
    """The share of ``got`` that differs from ``exact`` rounded to
    ``got``'s dtype."""
    if not got.numel():
        return 0.0
    return float((got != exact.to(got.dtype)).float().mean())


def split_check(name: str, a: dict, label: str) -> dict:
    """A bf16 K7 / K8 call held to its float64 value: the kernel may
    misround at most ``SPLIT_SHARE`` of its outputs, and the control (the
    plain version with its fp32 product operands rounded once to bf16)
    must misround more, else the check cannot tell the split from one
    rounding.  Returns the three shares (kernel, plain float32,
    control)."""
    import torch

    def once(t):
        return t.to(torch.bfloat16).to(t.dtype)

    a = serve_cast(a, torch.bfloat16)
    a64 = {k: v.to(torch.float64) if torch.is_tensor(v)
           and v.is_floating_point() else v for k, v in a.items()}
    exact = serve_plain_call(name, a64)
    got = dict(
        kernel=misrounded_share(serve_kernel_call(name, a), exact),
        plain=misrounded_share(serve_plain_call(name, a), exact),
        control=misrounded_share(serve_plain_call(name, a, once), exact))
    log(f"  {name} {label} call, hi + lo split: bf16 outputs off the "
        f"correctly rounded float64 value: kernel {got['kernel']:.5f}, plain "
        f"float32 {got['plain']:.5f}, control (operands rounded once to "
        f"bf16) {got['control']:.5f}; limit {SPLIT_SHARE}")
    if not got["kernel"] <= SPLIT_SHARE:
        fail(f"{name} {label}: the kernel misrounds {got['kernel']} of its "
             f"bf16 outputs, above {SPLIT_SHARE}")
    if not got["control"] > SPLIT_SHARE:
        fail(f"{name} {label}: the control misrounds {got['control']}, not "
             f"above {SPLIT_SHARE}: the check cannot see the split")
    return got


def time_serve_call(name: str, a: dict, on_card: bool) -> dict:
    """Kernel, plain and library ms of the call (library None where no
    PyTorch call computes it), its bound, and the kernel's and the
    library's own device ms from a cold L2 (each call of
    :func:`device_times` on the next of the :func:`cold_copies`) and the
    kernel's host us per call."""
    import torch

    nbytes, flops = serve_work(name, a)
    dname = str(a["buf" if name == "combine_rows" else "q"
                  if name == "flash_attention_bh" else "x"].dtype).split(".")[1]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dname]
    library = serve_library_call(name, a)
    kernel = lambda: serve_kernel_call(name, a)
    copies = [a]
    if on_card:
        dev = next(v.device for v in a.values() if torch.is_tensor(v))
        l2 = torch.cuda.get_device_properties(dev).L2_cache_size
        copies = cold_copies(name, a, nbytes, l2)
    args = itertools.cycle(copies)
    fns = {"kernel": lambda: serve_kernel_call(name, next(args))}
    if library is not None:
        libs = itertools.cycle([serve_library_call(name, c) for c in copies])
        fns["library"] = lambda: next(libs)()
    t = device_times(fns, on_card)
    return dict(
        ms=time_ms(kernel, on_card),
        plain_ms=time_ms(lambda: serve_plain_call(name, a), on_card),
        library_ms=None if library is None else time_ms(library, on_card),
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        mbytes=nbytes / 1e6, gflop=flops / 1e9,
        device_ms=t["kernel"][0], host_us=t["kernel"][1],
        library_device_ms=t.get("library", (None,))[0],
        cold_copies=len(copies),
    )


def serve_call_shape(name: str, a: dict) -> str:
    if name == "ssd_scan_h":
        return f"x {list(a['x'].shape)} B/C {list(a['B'].shape)}"
    if name == "gather_rows":
        return f"x {list(a['x'].shape)} idx {list(a['idx'].shape)}"
    if name == "combine_rows":
        return f"buf {list(a['buf'].shape)} idx {list(a['idx'].shape)}"
    return (f"q {list(a['q'].shape)} k {list(a['k'].shape)} kv_len "
            f"{a['kv_len']} q_offset {a['q_offset']}")


def serve_kernel_phase(recorded: dict, on_card: bool) -> dict:
    """Every recorded K5-K8 call of one prefill and one decode step against
    its plain version; the largest prefill and decode call of each kernel
    timed.  Returns per kernel its largest prefill call's record, the
    decode record beside it."""
    results: dict = {}
    largest: dict = {}
    for (name, phase, *_), (n_calls, args) in recorded.items():
        rec = results.setdefault(name, {"max_abs_err": 0.0, "checked": 0})
        for a in args:
            rec["max_abs_err"] = max(rec["max_abs_err"],
                                     check_serve_call(name, a, phase))
            rec["checked"] += 1
            size = serve_work(name, a)[0]
            if size > largest.get((name, phase), (-1, None))[0]:
                largest[(name, phase)] = (size, a)
        log(f"kernel {name:18s} {phase:7s} {serve_call_shape(name, args[0])}:"
            f" {n_calls} calls, each within tolerance of its plain version "
            "in bf16 and float32")
    for (name, phase), (_size, a) in sorted(largest.items()):
        t = time_serve_call(name, a, on_card)
        lib = ("none" if t["library_ms"] is None
               else f"{t['library_ms']:.4f} ms")
        log(f"  {name} largest {phase} call ({serve_call_shape(name, a)}, "
            f"{t['mbytes']:.2f} MB, {t['gflop']:.3f} GFLOP): kernel "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
            f"{lib}, bound {t['bound_ms']:.4f} ms ({t['bound_by']}); device "
            f"ms from a cold L2 ({t['cold_copies']} copies) "
            f"{fmt_ms(t['device_ms'])} (library "
            f"{fmt_ms(t['library_device_ms'])}), host us per call "
            f"{fmt_ms(t['host_us'])}")
        if phase == "prefill":
            results[name].update(t)
            if name in ("flash_attention_bh", "ssd_scan_h"):
                results[name]["split"] = split_check(name, a, phase)
        else:
            results[name]["decode"] = t
    return results


def serve_edge_calls(device, gen) -> list:
    """K5-K7 calls the served path does not make: for K5 a ragged row
    count, a row width that takes the 2-byte copy unit and all-pad
    indices; for K6 on three lanes K = 1, 6 and 9 (``KMAX`` 8 and the
    grouping past it) with sentinels, an all-sentinel call and an odd row
    width (the scalar path); GQA head dims 64 / 128 / 256 and 112 in
    prefill with Tq not a multiple of the kernel's 64 rows, fully masked
    attention rows, and q_offset > 0 with kv_len < Tk."""
    import torch

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(device)

    def idx(n, *shape):
        return torch.randint(0, n, shape, generator=gen,
                             dtype=torch.int32).to(device)

    def table(n, d):
        x = rnd(n + 1, d)
        x[-1] = 0.0
        return x

    t = table(777, 2048)
    pad = torch.full((64,), 777, dtype=torch.int32, device=device)
    calls = [
        ("gather_rows", dict(x=t, idx=idx(778, 1001))),
        ("gather_rows", dict(x=table(50, 37), idx=idx(51, 333))),
        ("gather_rows", dict(x=t, idx=pad)),
    ]
    calls += [("combine_rows", k6_edge_call(rnd(3, 259, D), N, K, gen))
              for D, N, K in ((2048, 333, 1), (2048, 333, 6),
                              (2048, 333, 9), (37, 50, 6))]
    calls.append(("combine_rows", dict(
        buf=rnd(3, 259, 2048), idx=torch.full(
            (3, 64, 6), 259, dtype=torch.int32, device=device),
        w=torch.rand(3, 64, 6, generator=gen).to(device))))
    for d, Tq, Tk, causal, window, kv_len, q_offset in (
            (64, 40, 40, True, 0, 40, 0), (128, 17, 300, True, 0, 201, 184),
            (256, 33, 64, False, 0, 50, 0), (112, 100, 150, True, 0, 150, 0),
            (192, 16, 64, True, 4, 44, 40), (192, 1, 512, True, 0, 77, 76)):
        calls.append(("flash_attention_bh", dict(
            q=rnd(6, Tq, d), k=rnd(6, Tk, d), v=rnd(6, Tk, d),
            scale=d ** -0.5, causal=causal, window=window, kv_len=kv_len,
            q_offset=q_offset)))
    return calls


def k6_edge_call(buf, N: int, K: int, gen, sentinel_lane=None) -> dict:
    """A lane-form K6 call on ``buf`` [G, R, D]: random indices, a quarter
    of them (and all K of ``sentinel_lane``'s last token) at the sentinel
    R, whose weights stay random."""
    import torch

    G, R = buf.shape[:2]
    idx = torch.randint(0, R, (G, N, K), generator=gen, dtype=torch.int32)
    idx[torch.rand(G, N, K, generator=gen) < 0.25] = R
    if sentinel_lane is not None:
        idx[sentinel_lane, -1] = R
    return dict(buf=buf, idx=idx.to(buf.device),
                w=torch.rand(G, N, K, generator=gen).to(buf.device))


def k6_guard_check(device, gen) -> float:
    """K6 on a table whose next row is NaN: buf [8, 512, 2048] is a view of
    the first 8 * 512 rows of a tensor whose last row is NaN, the
    sentinels in every lane and in full in the last lane's last token.
    The output must be finite and within tolerance of the plain version,
    in bf16 and float32: no sentinel is read.  Returns the bf16 max
    |difference|."""
    import torch

    G, R, D = 8, 512, 2048
    abs_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        base = torch.randn(G * R + 1, D, generator=gen).to(device, dtype)
        base[-1] = float("nan")
        a = k6_edge_call(base[:G * R].view(G, R, D), 8, 6, gen,
                         sentinel_lane=G - 1)
        got, want = serve_kernel_call("combine_rows", a), serve_plain_call(
            "combine_rows", a)
        if not bool(torch.isfinite(got).all()):
            fail(f"combine_rows guard call {dname}: non-finite output, a "
                 "sentinel read the NaN row")
        err = rel_err(got.float(), want.float())
        if not err <= SERVE_TOL[dname]:
            fail(f"combine_rows guard call {dname}: max rel error {err} > "
                 f"{SERVE_TOL[dname]}")
        if dtype == torch.bfloat16:
            abs_err = float(torch.max(torch.abs(got.float() - want.float())))
    log(f"kernel combine_rows       guard   (buf [{G}, {R}, {D}] before a "
        "NaN row, sentinels in every lane): finite, within tolerance in "
        "bf16 and float32")
    return abs_err


def k5_guard_check(device, gen) -> None:
    """K5 with indices -1, N and N + 5 on a table whose next rows are NaN:
    x [777, 2048] is a view of the first 777 rows of a tensor whose rows
    past it are NaN.  The output must be finite, zero in those rows (an
    index outside [0, N) reads a zero row and loads nothing) and equal to
    the plain version, in bf16 and float32."""
    import torch

    N, D, M = 777, 2048, 96
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        base = torch.randn(N + 6, D, generator=gen).to(device, dtype)
        base[N:] = float("nan")
        idx = torch.randint(0, N, (M,), generator=gen, dtype=torch.int32)
        bad = torch.arange(0, M, 4)                 # every 4th row
        idx[bad] = torch.tensor([-1, N, N + 5],
                                dtype=torch.int32)[torch.arange(len(bad)) % 3]
        a = dict(x=base[:N], idx=idx.to(device))
        got = serve_kernel_call("gather_rows", a)
        want = serve_plain_call("gather_rows", a)
        if not bool(torch.isfinite(got).all()):
            fail(f"gather_rows guard call {dname}: non-finite output, an "
                 "index outside [0, N) read past the table")
        if bool(got[bad.to(device)].any()):
            fail(f"gather_rows guard call {dname}: a row of an index "
                 "outside [0, N) is not zero")
        if not torch.equal(got, want):
            fail(f"gather_rows guard call {dname}: differs from "
                 "gather_rows_ref")
    log(f"kernel gather_rows        guard   (x [{N}, {D}] before NaN rows, "
        "indices -1, N, N + 5): finite, zero rows, equal to the plain "
        "version in bf16 and float32")


def unbuilt_head_dim_raises(device) -> None:
    """K7 on the card refuses a head dim its source is not built for (24)
    rather than padding it."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_bh

    t = torch.zeros(2, 8, 24, device=device, dtype=torch.bfloat16)
    try:
        flash_attention_bh(t, t, t, scale=1.0, causal=True)
    except ValueError as e:
        log(f"kernel flash_attention_bh edge    head dim 24 refused: {e}")
        return
    fail("flash_attention_bh: head dim 24, which the kernel is not built "
         "for, was not refused")


# ------------------------------------------------------ hybrid serve phase
HYBRID_ARCH = "zamba2-7b"
HYBRID_SOURCES = {
    "flash_attention_bh": SERVE_SOURCES["flash_attention_bh"],
    "ssd_scan_h": ("src/repro_torch/csrc/ssd_scan.cu",
                   "src/repro/kernels/ssd_scan/ssd_scan.py:85"),
}
# The hybrid oracle replays every engine call in float32: the same weights
# (the bf16 draw, cast exactly) and the same inputs, through the kernels'
# float32 builds and through the plain versions.  In bf16 no tolerance
# separates right from wrong: the random-weight stack of 94 residual blocks
# grows a difference of one rounding to O(1) logits, and the plain versions
# disagree with themselves at another K8 chunk about as much as with the
# kernels (:func:`forward_probe` prints both, not gated).  Each bf16
# kernel call is held to its plain version by the kernel phase.  logits:
# max |kernel - plain| <= HYBRID_LOGIT_TOL * max |plain| per call; float32
# roundings (1e-7) grown some ten-thousandfold stay under it
HYBRID_LOGIT_TOL = 1e-2


def hybrid_faults(chunk: int) -> dict:
    """The hybrid model bound to its kernels with a fault planted in K8's
    binding (the sources untouched), at the reference kernel's ``chunk``:
    the oracle must refuse each.  Both act on what a chunk hands the next,
    so they show at the first steps of every chunk but the first, and only
    a prompt longer than ``chunk`` shows them."""
    import torch

    from repro_torch.kernels.ssd_scan import ssd

    def restarted(x, dt, A, B, C):
        """K8 from a zero state at every chunk."""
        return torch.cat([ssd(x[:, s:s + chunk], dt[:, s:s + chunk], A,
                              B[:, s:s + chunk], C[:, s:s + chunk])
                          for s in range(0, x.shape[1], chunk)], dim=1)

    def drops_carried_state(x, dt, A, B, C, **kw):
        return restarted(x, dt, A, B, C)

    def drops_dt_weight(x, dt, A, B, C, **kw):
        """The state a chunk hands on sums B_s (x) x_s without dt_s: that is
        the carried part of K8 over x / dt (in float32), added to the
        restarted K8 over x."""
        xr = x.float() / dt[..., None]
        Bf, Cf = B.float(), C.float()
        carried = ssd(xr, dt, A, Bf, Cf) - restarted(xr, dt, A, Bf, Cf)
        return (restarted(x, dt, A, B, C).float() + carried).to(x.dtype)

    return {
        "K8 drops the carried state": bound_kernels(ssd=drops_carried_state),
        "K8 drops the state update's dt_s weight": bound_kernels(
            ssd=drops_dt_weight),
    }


def hybrid_edge_calls(device, gen) -> list:
    """K7 / K8 calls the served path does not make: K8 at T = 1, T below
    the chunk, a ragged last chunk, G = 2 and mamba2-780m's shape (H 48,
    P 64, N 128), and at T = 1, 63, 65 and 129 for both (P, N) (around the
    kernel's chunk of 64); K7's decode at kv_len 1, 63, 65 and 512 (one,
    one, two and eight key splits) at head dims 112 and 192."""
    import torch
    import torch.nn.functional as tf

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(device)

    calls = []
    for Bt, T, H, G, N in ((2, 1, 8, 1, 64), (2, 37, 8, 1, 64),
                           (1, 200, 8, 1, 64), (2, 150, 8, 2, 64),
                           (2, 300, 48, 1, 128), (2, 63, 8, 1, 64),
                           (2, 65, 8, 1, 64), (2, 129, 8, 1, 64),
                           (2, 1, 8, 1, 128), (2, 63, 8, 1, 128),
                           (2, 65, 8, 1, 128), (2, 129, 8, 1, 128)):
        calls.append(("ssd_scan_h", dict(
            x=rnd(Bt, T, H, 64), dt=tf.softplus(rnd(Bt, T, H)),
            A=-torch.exp(0.5 * rnd(H)), B=rnd(Bt, T, G, N),
            C=rnd(Bt, T, G, N))))
    for d in (112, 192):
        for kv_len in (1, 63, 65, 512):
            calls.append(("flash_attention_bh", dict(
                q=rnd(8, 1, d), k=rnd(8, 512, d), v=rnd(8, 512, d),
                scale=d ** -0.5, causal=True, window=0, kv_len=kv_len,
                q_offset=kv_len - 1)))
    return calls


def cast_params(params: dict, dtype) -> dict:
    """The nested dict of tensors in ``dtype``; each source tensor is freed
    once cast, so the two copies never coexist whole."""
    out = {}
    for k in list(params):
        v = params.pop(k)
        out[k] = cast_params(v, dtype) if isinstance(v, dict) else v.to(dtype)
    return out


def forward_probe(model, params, tokens) -> dict:
    """The model's forward over ``tokens`` through the kernels, through the
    plain versions, and through the plain versions with K8 at chunk 64 in
    place of 128 (the same function, rounded otherwise): max |diff| /
    max |logit| over every position, of the first two and of the last two.
    Printed, not gated (see HYBRID_LOGIT_TOL)."""
    import functools

    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.ssd_scan import ssd_scan_ref

    kern = forward_rows(model, params, tokens)
    with plain_kernels():
        plain = forward_rows(model, params, tokens)
    with bound_kernels(flash=attention_ref,
                       ssd=functools.partial(ssd_scan_ref, chunk=64)):
        plain64 = forward_rows(model, params, tokens)
    out = dict(kernel_vs_plain=rel_err(kern, plain),
               plain64_vs_plain=rel_err(plain64, plain))
    log(f"forward probe in {str(model.cfg.dtype).split('.')[1]} (not a "
        f"gate): {tuple(tokens.shape)} tokens, max |logit diff| / max "
        f"|logit| over every position: kernels vs plain versions "
        f"{out['kernel_vs_plain']:.3e}; plain versions with K8 at chunk 64 "
        f"vs 128 {out['plain64_vs_plain']:.3e}")
    return out


def count_params(params: dict):
    """(parameters, bytes) of a nested dict of tensors."""
    leaves, stack = [], [params]
    while stack:
        for v in stack.pop().values():
            (stack.append if isinstance(v, dict) else leaves.append)(v)
    return (sum(t.numel() for t in leaves),
            sum(t.numel() * t.element_size() for t in leaves))


def hybrid_run(device: str = "cuda", reduced_config: bool = False) -> dict:
    """The hybrid serve phase: zamba2-7b (full width and depth on the card,
    the reduced config for the CPU rehearsal) in bf16, six requests on four
    slots; then the oracle in float32 on the same weights.  Returns its
    summary (with the oracle's readings), the launches of the served path,
    the kernel records and the profile."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import CUDA_LAUNCHES, LAUNCHES, reset_launches
    from repro_torch.models import Model
    from repro_torch.serve import ServeEngine

    on_card = device == "cuda"
    cfg = (configs.reduced if reduced_config else configs.get)(HYBRID_ARCH)
    sizes = serve_sizes(on_card)
    # off the card the prompts are shorter than the reference's chunk: plant
    # the faults at a chunk the rehearsal's prompts cross
    fault_chunk = SSD_CHUNK if on_card else 4
    t0 = time.perf_counter()
    model = Model(cfg, device=device)
    params = model.init_params(seed=SERVE_SEED)
    card_sync(on_card)
    n_params, n_bytes = count_params(params)
    n_seg = cfg.n_layers // cfg.shared_attn_period
    log(f"hybrid: {cfg.name}, {cfg.n_layers} Mamba-2 layers ({cfg.n_ssm_heads} "
        f"SSD heads, P {cfg.ssm_head_dim}, N {cfg.ssm_state}, G "
        f"{cfg.ssm_groups}), d_model {cfg.d_model}, {n_seg} shared attention "
        f"applications ({cfg.n_heads} heads of {cfg.head_dim}), vocab "
        f"{cfg.vocab}, {cfg.dtype}; {n_params:,} parameters, "
        f"{n_bytes / 1e9:.2f} GB on {device}, drawn in "
        f"{time.perf_counter() - t0:.2f} s"
        + (f"; {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated"
           if on_card else ""))

    warm_up(model, params, sizes)
    kernels_of_path = tuple(HYBRID_SOURCES)
    recorded: dict = {}
    reset_launches()
    eng = ServeEngine(model, params, batch_slots=sizes["slots"],
                      max_len=sizes["max_len"])
    calls = recording_engine(eng, on_card, recorded)
    for r in serve_requests(cfg.vocab, sizes):
        eng.submit(r)
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    card_sync(on_card)
    wall = time.perf_counter() - t0
    check_served(done, sizes, cfg.vocab, "hybrid serve")
    launches = {k: LAUNCHES[k] for k in kernels_of_path}
    cuda_launches = {k: CUDA_LAUNCHES[k] for k in kernels_of_path}
    summ = serve_summary(calls, kernels_of_path)
    summ.update(wall_s=wall, tokens={r.rid: r.generated for r in done})
    log(f"hybrid serve: {len(done)} requests in {wall:.2f} s; "
        f"{summ['prefills']} prefills, {summ['prefill_tokens']} tokens, "
        f"{summ['prefill_tok_s']:.1f} prefill tokens/s; "
        f"{summ['decode_steps']} decode steps, {summ['decode_ms']:.3f} ms "
        f"per step; launches per prefill {summ['launches_per_prefill']}, "
        f"per decode step {summ['launches_per_decode']} (CUDA launches "
        f"{summ['cuda_launches_per_prefill']} and "
        f"{summ['cuda_launches_per_decode']}); kernels launched by the "
        f"served path: {launches}")
    if on_card:
        want = {"prefill": {"flash_attention_bh": n_seg,
                            "ssd_scan_h": cfg.n_layers},
                "decode": {"flash_attention_bh": n_seg, "ssd_scan_h": 0}}
        for tag, per in want.items():
            if summ[f"launches_per_{tag}"] != per:
                fail(f"hybrid serve: launches per {tag} "
                     f"{summ[f'launches_per_{tag}']}, expected {per}")

    if not all(bool(torch.isfinite(c["logits"]).all()) for c in calls):
        fail("hybrid serve: non-finite logits")
    summ["probe_bf16"] = forward_probe(model, params, calls[0]["tokens"])

    kernels = serve_kernel_phase(recorded, on_card)
    recorded.clear()
    gen = torch.Generator().manual_seed(2)
    for name, a in hybrid_edge_calls(device, gen):
        err = check_serve_call(name, a, "edge")
        kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], err)
        log(f"kernel {name:18s} edge    ({serve_call_shape(name, a)}): "
            "within tolerance in bf16 and float32")
    prof = None
    if on_card:
        prof = profile_serve(model, params, sizes, on_card)
        log(f"hybrid profile (4 requests): wall {prof['wall_ms']:.1f} ms, "
            f"device busy {prof['busy_ms']:.1f} ms, idle share "
            f"{prof['idle_share']:.3f}, {prof['device_ops']} device ops; "
            f"most device ms: {prof['top_device']}")

    # the oracle, in float32 (see HYBRID_LOGIT_TOL): full-precision products
    torch.backends.cuda.matmul.allow_tf32 = False
    params = cast_params(params, torch.float32)
    model = Model(dataclasses.replace(cfg, dtype=torch.float32),
                  device=device)
    summ["probe_float32"] = forward_probe(model, params, calls[0]["tokens"])
    kern, _ = replay(model, params, eng, calls, [], contextlib.nullcontext())
    calls32 = [dict(c, logits=lg) for c, lg in zip(calls, kern)]
    res = replay_plain(model, params, eng, calls32, [], on_card,
                       faults=hybrid_faults(fault_chunk),
                       tol=HYBRID_LOGIT_TOL)
    summ.update(res)
    log(f"oracle hybrid (float32): {len(calls)} engine calls through the "
        "kernels and through the plain versions of K7 and K8; max |logit "
        f"diff| / max |logit| {res['oracle_rel_err']:.3e} "
        f"(tolerance {HYBRID_LOGIT_TOL}); greedy tokens equal on all "
        f"{res['oracle_sure']} of {res['oracle_rows']} rows with a top-2 "
        "margin above it; no non-finite logit")
    for name, got in res["planted"].items():
        log(f"oracle hybrid refuses a planted fault, {name} (at chunk "
            f"{fault_chunk}): max |logit diff| / max |logit| "
            f"{got['rel_err']:.3e}, greedy tokens differ on {got['differ']} "
            f"of {got['sure']} rows with a clear margin")
    return dict(summary=summ, launches=launches, cuda_launches=cuda_launches,
                kernels=kernels, profile=prof, n_params=n_params,
                n_bytes=n_bytes)


def profile_serve(model, params, sizes: dict, on_card: bool) -> dict:
    """A short serve run (four requests) under ``torch.profiler``: the
    card's busy time (union of its kernel intervals) against the unprofiled
    wall time of the same run, and the ops taking the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import ServeEngine

    small = dict(sizes, prompts=sizes["prompts"][:4],
                 new=tuple(max(2, n // 4) for n in sizes["new"][:4]))

    def run():
        eng = ServeEngine(model, params, batch_slots=sizes["slots"],
                          max_len=sizes["max_len"])
        for r in serve_requests(model.cfg.vocab, small):
            eng.submit(r)
        eng.run_until_drained()
        card_sync(on_card)

    run()                                         # warm
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    on_device = [e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = _union_us((e.time_range.start, e.time_range.end)
                        for e in on_device) / 1e3
    ranked = sorted(prof.key_averages(),
                    key=lambda e: -e.self_device_time_total)[:6]
    top = ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.2f}"
                    for e in ranked if e.self_device_time_total)
    return dict(wall_ms=wall_ms, busy_ms=busy_ms,
                idle_share=1.0 - busy_ms / wall_ms,
                device_ops=len(on_device), top_device=top)


def serve_run(device: str = "cuda", reduced_config: bool = False) -> dict:
    """The serve phase: DeepSeek-V2-Lite (full width and depth on the card,
    the reduced config for the CPU rehearsal) in bf16 on 8 stacked EP lanes,
    served under every mode.  Returns per mode its summary, the launches
    of the served path, the kernel records and the profile."""
    import torch

    from repro_torch import configs
    from repro_torch.core.costmodel import LASSEN
    from repro_torch.kernels import CUDA_LAUNCHES, LAUNCHES, reset_launches
    from repro_torch.models import Mesh, Model, serving
    from repro_torch.serve import ServeEngine

    on_card = device == "cuda"
    cfg = (configs.reduced if reduced_config else configs.get)(SERVE_ARCH)
    mesh = Mesh(*SERVE_MESH)
    sizes = serve_sizes(on_card)
    t0 = time.perf_counter()
    params = Model(cfg, mesh=mesh, moe_mode="a2a",
                   device=device).init_params(seed=SERVE_SEED)
    card_sync(on_card)
    n_params, n_bytes = count_params(params)
    log(f"serve: {cfg.name}, {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_experts} experts top-{cfg.top_k} + {cfg.n_shared_experts} "
        f"shared, vocab {cfg.vocab}, {cfg.dtype}, EP lanes {mesh.axes}; "
        f"{n_params:,} parameters, {n_bytes / 1e9:.2f} GB on {device}, "
        f"drawn in {time.perf_counter() - t0:.2f} s"
        + (f"; {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated"
           if on_card else ""))

    def model_for(mode, cap=1.25):
        return Model(cfg, mesh=mesh, moe_mode=mode, moe_cap_factor=cap,
                     machine_params=LASSEN, device=device)

    warm_up(model_for("a2a"), params, sizes)

    modes, recorded, engines = {}, {}, {}
    reset_launches()
    for mode in SERVE_MODES:
        model = model_for(mode)
        t0 = time.perf_counter()
        eng = ServeEngine(model, params, batch_slots=sizes["slots"],
                          max_len=sizes["max_len"])
        plan_s = time.perf_counter() - t0
        calls = recording_engine(
            eng, on_card, recorded if mode in ORACLE_MODES else None)
        for r in serve_requests(cfg.vocab, sizes):
            eng.submit(r)
        decisions: list = []
        t0 = time.perf_counter()
        with routing(decisions, replay=False):
            done = eng.run_until_drained()
            card_sync(on_card)
        wall = time.perf_counter() - t0
        check_served(done, sizes, cfg.vocab, f"serve {mode}")
        summ = serve_summary(calls)
        summ.update(wall_s=wall, plan_s=plan_s,
                    decode_mode=eng.moe_plan.mode,
                    prefill_mode=eng.moe_prefill_plan.mode,
                    tokens={r.rid: r.generated for r in done})
        modes[mode] = summ
        engines[mode] = (model, eng, calls, decisions)
        log(f"serve {mode:10s}: {len(done)} requests in {wall:.2f} s "
            f"(plans {plan_s:.2f} s; decode plan {summ['decode_mode']}, "
            f"prefill plan {summ['prefill_mode']}); {summ['prefills']} "
            f"prefills, {summ['prefill_tokens']} tokens, "
            f"{summ['prefill_tok_s']:.1f} prefill tokens/s; "
            f"{summ['decode_steps']} decode steps, {summ['decode_ms']:.3f} "
            f"ms per step; launches per prefill "
            f"{summ['launches_per_prefill']}, per decode step "
            f"{summ['launches_per_decode']} (CUDA launches "
            f"{summ['cuda_launches_per_prefill']} and "
            f"{summ['cuda_launches_per_decode']})")
    card_sync(on_card)
    launches = {k: LAUNCHES[k] for k in SERVE_SOURCES}
    cuda_launches = {k: CUDA_LAUNCHES[k] for k in SERVE_SOURCES}
    log(f"kernels launched by the served path: {launches} (CUDA launches "
        f"{cuda_launches})")

    for mode in ORACLE_MODES:
        model, eng, calls, decisions = engines[mode]
        res = replay_plain(
            model, params, eng, calls, decisions, on_card,
            faults=planted_faults() if mode == ORACLE_MODES[0] else None)
        decisions.clear()
        modes[mode].update(res)
        log(f"oracle {mode:10s}: {len(calls)} calls through the plain "
            f"versions, routing replayed ({res['route_flips']} of "
            f"{res['route_rows']} lane-token routings would have differed); "
            f"max |logit diff| / max |logit| {res['oracle_rel_err']:.3e} "
            f"(tolerance {LOGIT_TOL}); greedy tokens equal on all "
            f"{res['oracle_sure']} of {res['oracle_rows']} rows with a top-2 "
            "margin above it")
        for name, got in res["planted"].items():
            log(f"oracle {mode:10s} refuses a planted fault, {name}: max "
                f"|logit diff| / max |logit| {got['rel_err']:.3e}, greedy "
                f"tokens differ on {got['differ']} of {got['sure']} rows with "
                "a clear margin")

    # ample capacity: no drops, so every transport computes one function
    first = serve_requests(cfg.vocab, sizes)[:sizes["slots"]]
    T = max(len(r.prompt) for r in first)
    toks = torch.zeros((len(first), T), dtype=torch.int32)
    for i, r in enumerate(first):
        toks[i, T - len(r.prompt):] = torch.as_tensor(r.prompt)
    agree = {}
    for mode in SERVE_MODES:
        logits, _ = serving.prefill(model_for(mode, AMPLE_CAP), params,
                                    {"tokens": toks.to(device)},
                                    max_len=sizes["max_len"])
        agree[mode] = logits.float().cpu()
    base = agree[SERVE_MODES[0]]
    for mode, lg in agree.items():
        err = float((lg - base).abs().max()) / float(base.abs().max())
        log(f"modes agree at cap_factor {AMPLE_CAP}: {mode} vs "
            f"{SERVE_MODES[0]} max |logit diff| / max |logit| {err:.3e}")
        if not err <= LOGIT_TOL:
            fail(f"modes disagree: {mode} vs {SERVE_MODES[0]} by {err}")
    del agree

    kernels = serve_kernel_phase(recorded, on_card)
    recorded.clear()
    gen = torch.Generator().manual_seed(1)
    for name, a in serve_edge_calls(device, gen):
        err = check_serve_call(name, a, "edge")
        kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], err)
        log(f"kernel {name:18s} edge    ({serve_call_shape(name, a)}): "
            "within tolerance in bf16 and float32")
    err = k6_guard_check(device, gen)
    kernels["combine_rows"]["max_abs_err"] = max(
        kernels["combine_rows"]["max_abs_err"], err)
    k5_guard_check(device, gen)
    prof = None
    if on_card:
        unbuilt_head_dim_raises(device)
        prof = profile_serve(engines["auto"][0], params, sizes, on_card)
        log(f"serve profile (auto, 4 requests): wall {prof['wall_ms']:.1f} "
            f"ms, device busy {prof['busy_ms']:.1f} ms, idle share "
            f"{prof['idle_share']:.3f}, {prof['device_ops']} device ops; "
            f"most device ms: {prof['top_device']}")
    return dict(modes=modes, launches=launches, cuda_launches=cuda_launches,
                kernels=kernels, profile=prof, n_params=n_params,
                n_bytes=n_bytes)


def run(device: str = "cuda", rows: int = 524_288, block_cols: int = 512,
        v_cycles: int = V_CYCLES) -> dict:
    """The AMG phases at ``rows`` unknowns on ``device``, ``v_cycles`` timed
    V-cycles per solve; returns the kernel records, the launch counts of
    the main path, the solve results and, under ``host``, what
    :func:`partitioned_run` takes from them."""
    import numpy as np
    import torch

    from repro_torch.amg import build_hierarchy, paper_problem
    from repro_torch.kernels import CUDA_LAUNCHES, LAUNCHES, reset_launches

    on_card = device == "cuda"
    t0 = time.perf_counter()
    h = build_hierarchy(paper_problem(rows))
    host_setup_s = time.perf_counter() - t0
    log(f"host setup: {host_setup_s:.2f} s")
    log(h.describe())
    exchange_phase(h, device, on_card)
    b = np.random.default_rng(0).normal(size=h.levels[0].A.nrows)
    reset_launches()
    solves, recorded, host_hist = solve_phase(h, b, device, block_cols,
                                              on_card, v_cycles)
    if on_card:
        torch.cuda.synchronize()
    launches = {k: LAUNCHES[k] for k in REPLACES}
    cuda_launches = {k: CUDA_LAUNCHES[k] for k in REPLACES}
    kernels, planted = path_kernel_phase(recorded, on_card)
    synthetic_kernel_phase(h, device, block_cols, on_card, kernels)
    return dict(kernels=kernels, launches=launches,
                cuda_launches=cuda_launches, solves=solves, planted=planted,
                host=dict(h=h, b=b, setup_s=host_setup_s, device=device,
                          block_cols=block_cols, v_cycles=v_cycles,
                          hist=host_hist))


def partitioned_run(amg: dict, coarse_max_iters: int = COARSE_MAX_ITERS,
                    dense_n: int = DENSE_N) -> dict:
    """The partitioned phase on the hierarchy, vector and settings of the
    AMG phases' result ``amg`` (:func:`run`), its coarse-gather solves to
    ``coarse_max_iters``, then the dense executor on ``dense_n`` values.
    ``main`` runs it after the serve paths."""
    host = amg["host"]
    device = host["device"]
    on_card = device == "cuda"
    t0 = time.perf_counter()
    partitioned, coarse_counts = partitioned_phase(
        host["h"], host["b"], host["setup_s"], device, host["block_cols"],
        on_card, host["v_cycles"], amg["solves"][PARTITIONED],
        coarse_max_iters)
    t1 = time.perf_counter()
    dense = dense_phase(coarse_counts, device, on_card, dense_n)
    log(f"partitioned phase {t1 - t0:.1f} s, dense phase "
        f"{time.perf_counter() - t1:.1f} s")
    return dict(partitioned=partitioned, dense=dense,
                coarse_counts=coarse_counts)


def build_kernels() -> None:
    """Build every CUDA source at once, one nvcc each, in parallel."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.flash_attention import cuda as fa_cuda
    from repro_torch.kernels.moe_pack import cuda as mp_cuda
    from repro_torch.kernels.spmv_ell import cuda as sp_cuda
    from repro_torch.kernels.ssd_scan import cuda as ssd_cuda

    libs = [sp_cuda.LIBRARY, mp_cuda.LIBRARY, fa_cuda.LIBRARY,
            ssd_cuda.LIBRARY]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        paths = list(pool.map(lambda lib: lib.build(), libs))
    log(f"nvcc build: {time.perf_counter() - t0:.2f} s -> "
        f"{', '.join(p.name for p in paths)}")
    for lib in libs:
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {lib.source.name}: {line.strip()}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    log(f"device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    build_kernels()
    res = run("cuda")
    missing = [k for k, n in res["launches"].items() if n <= 0]
    log(f"kernels launched by the solves: {res['launches']}")
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    for config, want in VCYCLE_LAUNCHES.items():
        got = {k: n / V_CYCLES
               for k, n in res["solves"][config]["launches"].items() if n}
        if got != want:
            fail(f"solve {'/'.join(config)}: launches per V-cycle {got}, "
                 f"expected {want}")
    log(f"AMG phases done at {time.perf_counter() - t_start:.1f} s")
    serve = serve_run("cuda")
    missing = [k for k, n in serve["launches"].items() if n <= 0]
    if missing:
        fail(f"kernels never launched on the served path: {missing}")
    log(f"serve phase done at {time.perf_counter() - t_start:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()            # DeepSeek's weights leave the card
    hybrid = hybrid_run("cuda")
    missing = [k for k, n in hybrid["launches"].items() if n <= 0]
    if missing:
        fail(f"kernels never launched on the hybrid path: {missing}")
    log(f"hybrid phase done at {time.perf_counter() - t_start:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()            # zamba2's weights leave the card
    part_res = partitioned_run(res)
    part = part_res["partitioned"]["launches"]
    missing = [k for k in ("spmv_ell_blocked", "spmv_ell_blocked_skip")
               if part[k] <= 0]
    if missing:
        fail(f"kernels never launched on the partitioned path: {missing}")
    log(f"partitioned and dense phases done at "
        f"{time.perf_counter() - t_start:.1f} s")
    cal = calibrate_phase(res, part_res, card_figures(res),
                          ROOT / "chiprun_out" / "calibrate")["launches"]
    missing = [k for k in CALIBRATE_KERNELS if cal[k] <= 0]
    if missing:
        fail(f"kernels never launched in the calibrate phase: {missing}")
    log(f"calibrate phase done at {time.perf_counter() - t_start:.1f} s")
    timing = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
              "device_ms", "host_us", "library_device_ms")
    records = []
    for name in REPLACES:
        rec = res["kernels"][name]
        records.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=res["launches"][name],
            cuda_launches=res["cuda_launches"][name],
            partitioned_launches=part[name],
            calibrate_launches=cal[name],
            max_abs_err=rec["max_abs_err"],
            **{k: rec[k] for k in timing}))
    # K7 runs on both serve paths: its launches are both paths' and its
    # times those of its largest DeepSeek prefill call
    for name, (source, replaces) in {**SERVE_SOURCES,
                                     **HYBRID_SOURCES}.items():
        path = serve if name in SERVE_SOURCES else hybrid
        rec = path["kernels"][name]
        err = max(p["kernels"][name]["max_abs_err"] for p in (serve, hybrid)
                  if name in p["kernels"])
        records.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(p["launches"].get(name, 0) for p in (serve, hybrid)),
            cuda_launches=sum(p["cuda_launches"].get(name, 0)
                              for p in (serve, hybrid)),
            max_abs_err=err, **{k: rec[k] for k in timing},
            **({"decode": {k: rec["decode"][k] for k in timing}}
               if "decode" in rec else {}),
            **({"split": rec["split"]} if "split" in rec else {})))
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

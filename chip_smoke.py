#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It drives the port's paths on the card and fails (non-zero exit) if
any phase fails:

1. builds the CUDA kernels K1-K8 and K7's backward from
   ``src/repro_torch/csrc``, one ``nvcc`` per source, in parallel;
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
   built for, and profiles a short serve run; then, on the same weights,
   the adaptive engine (``ServeEngine(adaptive=True, observe=True,
   refit_every=8)`` under ``auto``): 12 steady decode steps must re-plan
   nothing (no event, no new plan-cache or executor miss); with every MoE
   layer's router zeroed exactly one ``ReplanEvent`` must fire (drift above
   0.3, a transport mode) and none in 4 more steps, each of which is held
   to its replay through the plain K5-K7 under the new plan (logits within
   2^-5; K5-K7 must launch); at least one converged ``RefitEvent`` must set
   the planner's params; ``engine.verify()`` passes before and after and
   refuses a planted broken plan; the router is restored; then the elastic
   engine (``ServeEngine(elastic=True)``, :func:`elastic_serve_phase`): 4
   decode steps on the 8 lanes, ``resize(4)`` (geometry (data 1, model 4),
   no weight tensor moved), 4 more, held to a cold 4-lane engine on the
   same weight tensors (greedy tokens identical, final logits within
   2^-5), every engine call after the resize replayed through the plain
   K5-K7, K5-K7 calls per decode step on 4 lanes beside 8 lanes', a warm
   ``resize(8)`` back, and a planted fault (one slot's last generated token
   dropped before the resume) that must be refused;
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
7. dense serve (:func:`dense_run`): draws gemma3-1b (26 layers, d 256,
   5 local layers at window 512 : 1 global) and qwen2-0.5b (24 layers,
   d 64, a GQA group of 7) at full width and depth in bf16 (seeded) and
   serves six requests (prompts of 520-1,100 tokens, so gemma3's local
   caches start full and roll at every decode step) through
   ``ServeEngine``, counting K7 calls and CUDA launches per prefill and
   decode step (one call a layer, a decode call two launches); replays
   every engine call through the plain K7 in bf16 (logits within 2^-5,
   no clear-margin greedy flip) and under a fault planted in K7's binding
   (gemma3's local layers at window 0; qwen2's decode reading its
   caches' unfilled slots), which the oracle must refuse; holds every K7
   call of one prefill and one decode step against the plain version in
   bf16 and float32 and times the largest (gemma3's also its largest
   windowed prefill call) from a cold L2 beside ``sdpa``; then
   nemotron-4-15b and qwen2-vl-2b at full width with 4 layers (the vlm
   with precomputed embeddings at M-RoPE positions whose three rows
   differ): a prefill and 4 decode steps held to the plain K7; last K7's
   causal prefill at d 64, 128, 192 and 256 on one grid (BH 16 and 7, T
   1,100), each held to the plain K7 and timed per FLOP;
8. train (:func:`train_run`): qwen2-0.5b at full width and depth in
   float32 with remat, through ``repro_torch.launch.train``'s main path
   (6 steps of 8 x 1,024 tokens, a checkpoint every 3; the loss must fall;
   a run resumed from the first checkpoint must end bitwise on the
   uninterrupted one; K7's forward 48 and its backward 24 calls a step);
   one lane-step through the kernels against K7's forward and backward
   bound to their plain versions, and with a backward fault planted (dK
   of the last key tile at zero, refused); every distinct K7 forward and
   backward call of it held to the plain versions in bf16 and float32 and
   timed from a cold L2 beside ``sdpa``'s; ``make_dp_train_step`` on 8
   data-parallel lanes stacked on the card under ``jit``, ``ring``,
   ``hier`` and ``auto`` (``LASSEN``), each explicit variant's synced
   gradient within 8 2^-24 mean_p |g_p| of the lanes' float64 mean and a
   planted fault (the plan's first round dropped) refused; ``repro``'s
   ``check_grad_sync`` problem, every variant within 1e-12 of ``jit``;
9. partitioned, last: builds the hierarchy of the AMG phases' matrix by the
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
10. verify: ``verify_hierarchy`` over the paper hierarchy in the flat and
   blocked layouts (the flat one set up with ``REPRO_VERIFY=1``, so every
   plan, executor and dense executor is checked on insertion; the seconds
   by namespace printed) and over the partitioned hierarchy, the blocked
   ones on the bucket-major operands the card holds; every CUDA kernel's
   attributes against the card's limits (one JSON line; registers
   cross-checked with the ``ptxas`` log); and five planted faults that must
   be refused naming their rank, slot, bucket or kernel (a moved ELL
   nonzero, a bucket dropped from K4's map, a swapped scatter index, an
   executor audited against a foreign plan, K7 over the shared-memory
   limit);
11. elastic (:func:`elastic_phase`): the paper problem flat/off and
   blocked/off, each in a fresh ``PlanCache``: 3 V-cycles on 8 ranks, a
   heartbeat ``repartition`` to 4 (cold), 3 more from the 8-rank iterate
   (within 1e-12 of a cold 4-rank solve of 6), a grow-back to 8 that must
   re-plan and re-bind nothing (its solve within 1e-10 of the cold 8-rank
   one, ``VCYCLE_LAUNCHES`` a V-cycle), the re-plan seconds cold and
   warm; on flat/off also the checkpoint (the 8-rank iterate and a bf16
   DeepSeek ``w_gate`` saved asynchronously and restored bitwise; the
   resume on 4 ranks bitwise the shrink's; a flipped byte and a short
   template refused), the injected straggler (``ElasticController``: one
   rebalance of host 2 with a ``straggler-refit``, the rebalanced solve
   below 1e-8) and two planted faults (a grow-back through a fresh cache
   reads cold; a resume from the 8-rank layout misses 1e-12);
12. calibrate, last (no profiler): times the rate probes
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
13. checks that each path launched each of its kernels (the AMG solves
   the launches per V-cycle of ``VCYCLE_LAUNCHES``, the partitioned solve
   K2 and K4, the calibrate phase K1, K2 and K4), and prints one JSON
   line with every kernel's record: calls (``launches``) and
   ``cuda_launches`` on the main path (K1-K4 also
   ``partitioned_launches`` and ``calibrate_launches``; every kernel its
   ``elastic_launches``, K1, K2, K4 and K5-K7 above 0; K7 its
   ``dense_launches`` and, under ``dense``, the dense models' timed
   calls, ``train_launches`` and its train calls' times; K7's backward
   ``flash_attention_bh_bwd``), ``ms`` by CUDA events, ``device_ms`` and ``host_us``
   (:func:`device_times`), bound, plain and library times.

Its last line is ``{"ok": true, "device": {...}}``.  It uses no JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import inspect
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

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
    call, at least once; a shortfall is logged, and a session with no
    device event at all gives device ms None."""
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


SLEEP_CYCLES = 1 << 20       # about 0.6 ms of the card's clock


def slept_event_ms(fn, iters: int) -> float:
    """Median ms of ``fn``'s device work, each call between two CUDA events
    queued behind a device sleep (``torch.cuda._sleep``) that outlasts the
    host's issue of the call, so no launch gap falls between the events."""
    import torch

    times = []
    for _ in range(iters):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return sorted(times)[len(times) // 2]


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
               n_levels=info.n_levels, setup_records=info.records,
               hierarchy=dh)
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


# --------------------------------------------------------------- verify phase
@contextlib.contextmanager
def verify_on_insertion():
    """``REPRO_VERIFY=1`` while the block runs: every plan, executor and
    dense executor entering a plan cache is verified."""
    import os

    saved = os.environ.get("REPRO_VERIFY")
    os.environ["REPRO_VERIFY"] = "1"
    try:
        yield
    finally:
        if saved is None:
            del os.environ["REPRO_VERIFY"]
        else:
            os.environ["REPRO_VERIFY"] = saved


def refused(label: str, fn) -> dict:
    """``fn()`` must raise a ``VerifyError`` naming a rank, slot, bucket or
    kernel; returns its context."""
    from repro_torch.verify import VerifyError

    try:
        fn()
    except VerifyError as e:
        named = [k for k in ("rank", "slot", "bucket", "kernel", "ghost_slot")
                 if k in e.context]
        if not named:
            fail(f"verify: planted fault {label} refused without naming a "
                 f"rank, slot or bucket: {e}")
        log(f"verify refuses a planted fault, {label}: {e}")
        return dict(e.context)
    fail(f"verify: planted fault {label} was not refused")


def planted_verify_faults(dh, attrs: list, limits: dict, device) -> dict:
    """The five planted faults of the verify phase, on the card's objects
    of the blocked hierarchy ``dh`` (its first level with a ghost bucket)
    and the kernel attributes."""
    import dataclasses as dc

    import numpy as np
    import torch

    from repro_torch.core import NeighborAlltoallV, make_executor
    from repro_torch.sparse import row_block_bucket_map
    from repro_torch.verify import (
        audit_executor,
        check_bucket_map,
        check_kernel_attributes,
        verify_ell_blocked,
    )

    k = next(i for i, lv in enumerate(dh.levels)
             if lv.A.ell.n_ghost_buckets and lv.A.coll.device_plan.n_rounds)
    op = dh.levels[k].A
    ell = op.ell
    cols, vals = dh.bound_product(k, "A").operands
    out = {}

    # a nonzero of the card's bucket-major operands moved to another row
    bad_vals = vals.clone()
    b, r, kk = torch.nonzero(bad_vals[0] != 0)[0].tolist()
    r2, k2 = torch.nonzero(bad_vals[0, b] == 0)[-1].tolist()
    bad_vals[0, b, r2, k2] = bad_vals[0, b, r, kk]
    bad_vals[0, b, r, kk] = 0
    out["moved_nonzero"] = refused(
        f"a nonzero of level {k} moved in bucket {b} from row {r} to row "
        f"{r2}", lambda: verify_ell_blocked(ell, op.part, cols, bad_vals))

    # a live bucket dropped from K4's skip map
    lists, counts = row_block_bucket_map(ell)
    p, rb = (int(v) for v in np.argwhere(counts > 0)[0])
    counts = counts.copy()
    lists = lists.copy()
    counts[p, rb] -= 1
    lists[p, rb, int(counts[p, rb])] = 0
    out["dropped_bucket"] = refused(
        f"level {k} rank {p} row block {rb}'s last bucket dropped",
        lambda: check_bucket_map(ell, lists, counts))

    # one round's scatter indices swapped for one rank, bound and audited
    dplan = op.coll.device_plan
    bad_plan = dc.replace(dplan, steps=[
        dc.replace(st, rounds=list(st.rounds)) for st in dplan.steps])
    st = next(st for st in bad_plan.steps
              if any(rnd.width > 1 for rnd in st.rounds))
    i = next(i for i, rnd in enumerate(st.rounds) if rnd.width > 1)
    rnd = st.rounds[i]
    sc = rnd.scatter.copy()
    q = int(np.argmax((sc[:, 0] != sc[:, 1])))
    sc[q, [0, 1]] = sc[q, [1, 0]]
    st.rounds[i] = dc.replace(rnd, scatter=sc)
    out["swapped_scatter"] = refused(
        f"level {k} step {st.name} round {i}: rank {q}'s first two scatter "
        "indices swapped",
        lambda: audit_executor(make_executor(bad_plan, device), dplan,
                               device))

    # the level's executor audited against its pattern's plan under
    # another strategy
    other = next(s for s in ("standard", "partial", "full")
                 if s != op.coll.strategy)
    foreign = NeighborAlltoallV.init(op.part.pattern, dh.topo, other)
    fn = dh.cache.executor(op.part.pattern, dh.topo, device,
                           strategy=dh.strategy, value_bytes=dh.value_bytes,
                           params=dh.params)
    out["foreign_plan"] = refused(
        f"level {k}'s {op.coll.strategy} executor audited against the "
        f"{other} plan of its pattern",
        lambda: audit_executor(fn, foreign.device_plan, device))

    # K7's widest prefill launched with more shared memory than the card has
    k7 = max((a for a in attrs if a["name"].startswith("attn_prefill")),
             key=lambda a: a["dyn_smem"])
    over = dict(k7, dyn_smem=limits["smem_per_block_optin"] + 1024,
                max_dyn_smem=limits["smem_per_block_optin"] + 1024)
    out["k7_smem"] = refused(
        f"{k7['name']} with {over['dyn_smem']} bytes of dynamic shared "
        "memory", lambda: check_kernel_attributes([over], limits))
    return out


def verify_seconds_by_namespace() -> dict:
    """The ``plan_cache/verify_seconds`` histogram: (insertions, seconds)
    by namespace."""
    from repro_torch.obs import default_obs

    hist = default_obs().snapshot()["histograms"].get(
        "plan_cache/verify_seconds", {"series": []})
    return {row["labels"].get("ns", ""): (row["count"], row["sum"])
            for row in hist["series"]}


def verify_phase(amg: dict, part_res: dict, on_card: bool) -> dict:
    """The verifier on the card's objects: ``verify_hierarchy`` over the
    host-built paper hierarchy in the flat and blocked layouts (the flat
    one set up with ``REPRO_VERIFY=1`` and a coarse allgatherv, so every
    plan, executor and dense executor is checked on insertion; the seconds
    by namespace logged) and over ``setup_partitioned``'s hierarchy; every
    CUDA kernel's attributes against the card's limits (one JSON line); and
    five planted faults, each of which must be refused naming its rank,
    slot, bucket or kernel.  A ``VerifyError`` on a valid object ends the
    run."""
    from repro_torch import resolve_device
    from repro_torch.amg import DistributedHierarchy
    from repro_torch.core import PlanCache
    from repro_torch.kernels.flash_attention import cuda as fa_cuda
    from repro_torch.kernels.moe_pack import cuda as mp_cuda
    from repro_torch.kernels.spmv_ell import cuda as sp_cuda
    from repro_torch.kernels.ssd_scan import cuda as ssd_cuda
    from repro_torch.obs import default_obs
    from repro_torch.verify import (
        check_build_log_registers,
        check_kernel_attributes,
        read_kernel_attributes,
        verify_hierarchy,
    )

    host = amg["host"]
    h, bc = host["h"], host["block_cols"]
    device = resolve_device(host["device"])
    t_phase = time.perf_counter()
    obs = default_obs()
    obs.reset()
    obs.enable()
    out: dict = {"hierarchies": {}}
    hierarchies = {}
    try:
        for variant in ("flat", "blocked"):
            insertion = variant == "flat"
            t0 = time.perf_counter()
            with (verify_on_insertion() if insertion
                  else contextlib.nullcontext()):
                dh = DistributedHierarchy.setup(
                    h, N_PROCS, procs_per_region=PROCS_PER_REGION,
                    strategy="auto", cache=PlanCache(), spmv_variant=variant,
                    spmv_block_cols=bc,
                    coarse_gather="auto" if insertion else "off",
                    device=device)
            setup_s = time.perf_counter() - t0
            if insertion:
                by_ns = verify_seconds_by_namespace()
                out["insertion"] = dict(setup_s=setup_s, by_ns=by_ns)
                log(f"verify: {variant} set-up with REPRO_VERIFY=1 in "
                    f"{setup_s:.2f} s; verify on insertion by namespace "
                    "(insertions, seconds): " + ", ".join(
                        f"{ns} {n} {sec:.3f}"
                        for ns, (n, sec) in sorted(by_ns.items())))
                if not by_ns.get("collective", (0,))[0] or not by_ns.get(
                        "executor_audit", (0,))[0] or not by_ns.get(
                        "dense_executor_audit", (0,))[0]:
                    fail(f"verify: insertions not all verified: {by_ns}")
            hierarchies[variant] = dh
        hierarchies["partitioned"] = part_res["partitioned"]["hierarchy"]
        for name, dh in hierarchies.items():
            t0 = time.perf_counter()
            counts = verify_hierarchy(dh)
            secs = time.perf_counter() - t0
            out["hierarchies"][name] = dict(counts=counts, seconds=secs)
            log(f"verify_hierarchy {name}: {counts} in {secs:.2f} s")
    finally:
        obs.disable()
    spans = {}
    for ev in obs.spans.events():
        if ev.name.startswith("verify/"):
            spans[ev.name] = spans.get(ev.name, 0.0) + ev.duration
    log("verify: seconds by pass (spans): " + ", ".join(
        f"{k} {v:.2f}" for k, v in sorted(spans.items())))
    out["pass_seconds"] = spans

    attrs, limits = (read_kernel_attributes(device) if on_card
                     else (stand_in_attributes(), STAND_IN_LIMITS))
    print(json.dumps({"kernel_attributes": attrs, "device_limits": limits}))
    got = check_kernel_attributes(attrs, limits)
    # the CPU rehearsal builds nothing, so it has no ptxas log to read
    logged = ({lib.source.name: check_build_log_registers(
        attrs, lib.source.name, lib.build_log)
        for lib in (sp_cuda.LIBRARY, mp_cuda.LIBRARY, fa_cuda.LIBRARY,
                    fa_cuda.BWD_LIBRARY, ssd_cuda.LIBRARY)}
        if on_card else "not built here")
    worst = max(attrs, key=lambda a: a["num_regs"] * a["threads"])
    log(f"verify: {got['kernels']} CUDA kernels within the card's limits "
        f"({got['k7_head_dims']} K7 prefill head dims at their tiles' "
        f"shared memory; most registers a block: {worst['name']} "
        f"{worst['num_regs']} x {worst['threads']}); register counts "
        f"against the ptxas log: {logged}")
    out["kernels_checked"] = got
    out["planted"] = planted_verify_faults(hierarchies["blocked"], attrs,
                                           limits, device)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"verify phase {out['seconds']:.1f} s")
    return out


# stand-ins for the CPU rehearsal, which has no card to read: the H100's
# limits, and one entry of each launch shape the checks parse
STAND_IN_LIMITS = dict(regs_per_sm=65536, smem_per_block_optin=232448,
                       smem_per_sm=233472, threads_per_sm=2048, sm_count=132,
                       regs_per_block=65536)


def stand_in_attributes() -> list:
    from repro_torch.verify import flash_prefill_smem_bytes

    base = dict(num_regs=32, static_smem=0, max_threads_per_block=1024,
                local_bytes=0, threads=128, dyn_smem=0, blocks_per_sm=8,
                min_blocks=1, max_dyn_smem=49152)
    smem = flash_prefill_smem_bytes(4, 256)
    return [dict(base, name="spmv_ell_kernel<f64>", source="spmv_ell.cu",
                 symbol="_Z15spmv_ell_kernelIdEvv", threads=256,
                 min_blocks=0),
            dict(base, name="attn_prefill_f32_kernel<256>",
                 source="flash_attention.cu",
                 symbol="_ZN8attn_fwd3f3223attn_prefill_f32_kernelILi256EEEv"
                        "PKfS3_S3_PfS4_iifiiii", dyn_smem=smem,
                 max_dyn_smem=smem, blocks_per_sm=2, min_blocks=2)]


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


# --------------------------------------------------------- elastic phase
ELASTIC_CONFIGS = (("flat", "off"), ("blocked", "off"))
ELASTIC_KERNELS = ("spmv_ell", "spmv_ell_blocked", "spmv_ell_blocked_skip")
ELASTIC_SHRINK_TO = 4                # ranks left after the heartbeat
ELASTIC_K, ELASTIC_M = 3, 3          # V-cycles before and after a resize
ELASTIC_SHRINK_TOL = 1e-12           # resumed vs cold: the reference's bar
ELASTIC_GROW_TOL = 1e-10             # grown-back vs cold, the same
STRAGGLER_HOST, STRAGGLER_SLOW = 2, 3.0
STRAGGLER_STEPS, STRAGGLER_PATIENCE, STRAGGLER_COOLDOWN = 24, 3, 8
STRAGGLER_TOL, STRAGGLER_MAX_ITERS, STRAGGLER_RESID = 1e-8, 100, 1e-6
# one DeepSeek-V2-Lite layer's expert gate, the checkpoint's bf16 leaf
CKPT_BF16_SHAPE = (64, 2048, 1408)


def max_rel(got, want) -> float:
    import numpy as np

    return float(np.abs(got - want).max()
                 / max(float(np.abs(want).max()), 1e-300))


def elastic_solve(dh, b, iters: int, x0=None):
    """``iters`` V-cycles of ``dh`` from ``x0``; (x, the K1-K4 launches
    they made)."""
    from repro_torch.kernels import LAUNCHES

    before = dict(LAUNCHES)
    x, _ = dh.solve(b, tol=0.0, max_iters=iters, x0=x0)
    return x, {k: LAUNCHES[k] - before[k] for k in REPLACES
               if LAUNCHES[k] > before[k]}


def elastic_checkpoint(mgr, x_mid, step: int, device, resume,
                       bf16_shape=CKPT_BF16_SHAPE) -> dict:
    """The checkpoint part: ``x_mid`` saved asynchronously, restored into a
    template and resumed through ``resume`` (must give the same iterate
    bit for bit); one DeepSeek layer's bf16 ``w_gate`` saved and restored
    bitwise; a flipped byte must raise ``IOError`` and a template with one
    leaf too few ``ValueError``."""
    import numpy as np
    import torch

    from repro_torch.runtime import restore_checkpoint

    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(3)
    w_gate = torch.randn(bf16_shape, generator=gen, device=device,
                         dtype=torch.float32).to(torch.bfloat16)
    mgr.save(step, {"x": torch.as_tensor(x_mid, device=device),
                    "w_gate": w_gate})
    template = {"x": torch.zeros(x_mid.shape, dtype=torch.float64,
                                 device=device),
                "w_gate": torch.empty_like(w_gate)}
    got_step, tree = mgr.restore_latest(template)
    secs = time.perf_counter() - t0
    if got_step != step or tree["x"].device != template["x"].device:
        fail(f"checkpoint: restored step {got_step} on {tree['x'].device}")
    if not torch.equal(tree["w_gate"], w_gate):
        fail("checkpoint: the bf16 w_gate is not restored bitwise")
    x_back = tree["x"].cpu().numpy()
    if not np.array_equal(x_back, x_mid):
        fail("checkpoint: the iterate is not restored bitwise")
    out = dict(seconds=secs, bytes=int(w_gate.numel() * 2 + x_mid.nbytes),
               resumed=resume(x_back), planted={})
    path = Path(mgr.dir) / f"step_{step:09d}"
    victim = path / "leaf_00001.bin"       # "x": the keys sort w_gate, x
    raw = bytearray(victim.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    victim.write_bytes(bytes(raw))
    for name, tmpl, err in (("a flipped byte", template, IOError),
                            ("a template one leaf short",
                             {"x": template["x"]}, ValueError)):
        try:
            restore_checkpoint(mgr.dir, tmpl)
        except err as e:
            out["planted"][name] = f"{type(e).__name__}: {e}"
            log(f"checkpoint refuses a planted fault, {name}: "
                f"{out['planted'][name]}")
        else:
            fail(f"checkpoint: restored through {name}")
    del w_gate, tree, template
    return out


def straggler_part(dh, h, b, cache, on_card: bool) -> dict:
    """The injected straggler on an 8-rank flat hierarchy: per-level
    exchange samples into a ``TraceRecorder``, then 24 synthetic step-time
    vectors (host 2 at 3x with 1 % jitter, as the reference's program) into
    an ``ElasticController``: exactly one rebalance, host 2 with the fewest
    fine-level rows, a converged refit, and the rebalanced solve below
    1e-8 with a host residual below 1e-6."""
    import numpy as np

    from repro_torch.kernels import LAUNCHES
    from repro_torch.profile import TraceRecorder
    from repro_torch.runtime import ElasticController, StragglerConfig

    tracer = TraceRecorder()
    t0 = time.perf_counter()
    dh.measure_exchange_seconds(iters=2, warmup=1, tracer=tracer)
    ctrl = ElasticController(
        N_PROCS, cache=cache, tracer=tracer,
        straggler_cfg=StragglerConfig(patience=STRAGGLER_PATIENCE),
        cooldown=STRAGGLER_COOLDOWN)
    base = np.full(N_PROCS, 0.010)
    events = []
    for t in range(STRAGGLER_STEPS):
        times = base.copy()
        if not events:
            times[STRAGGLER_HOST] *= STRAGGLER_SLOW
        times *= 1.0 + 0.01 * np.sin(t)
        flagged = ctrl.observe_step_times(times)
        if flagged:
            if flagged != [STRAGGLER_HOST]:
                fail(f"straggler: flagged {flagged}")
            dh, ev = ctrl.mitigate_hierarchy(dh, flagged)
            events.append(ev)
            log(f"straggler: {ev}; {ev.resize}")
    if len(ctrl.rebalance_events) != 1 or len(events) != 1:
        fail(f"straggler: {len(ctrl.rebalance_events)} rebalance events")
    ev = events[0]
    rows = np.diff(dh.levels[0].A.part.offsets)
    log(f"straggler: fine-level rows a rank after the rebalance {rows}")
    if not (rows[STRAGGLER_HOST] == rows.min()
            and rows[STRAGGLER_HOST] < rows.max()):
        fail(f"straggler: host {STRAGGLER_HOST} does not hold the fewest "
             f"rows: {rows}")
    if not (ev.refit and ev.params_name == "straggler-refit"
            and dh.params.name == "straggler-refit"):
        fail(f"straggler: no refit ({ev})")
    before = dict(LAUNCHES)
    x, hist = dh.solve(b, tol=STRAGGLER_TOL, max_iters=STRAGGLER_MAX_ITERS)
    if on_card and LAUNCHES["spmv_ell"] <= before["spmv_ell"]:
        fail("straggler: K1 not launched by the rebalanced solve")
    A = h.levels[0].A
    resid = float(np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b))
    log(f"straggler: the rebalanced hierarchy ({dh.params.name}, "
        f"rel_rmse {ev.rel_rmse:.3f}) reaches {hist[-1]:.3e} in "
        f"{len(hist)} V-cycles; host ||b - A x|| / ||b|| {resid:.3e}; "
        f"strategies {[lv.A.strategy for lv in dh.levels]}")
    if not (hist[-1] < STRAGGLER_TOL and resid < STRAGGLER_RESID):
        fail(f"straggler: the rebalanced solve ends at {hist[-1]:.3e}, "
             f"residual {resid:.3e}")
    return dict(event=str(ev), resize=str(ev.resize), rows=rows.tolist(),
                rel_rmse=ev.rel_rmse, iters=len(hist), final=hist[-1],
                resid=resid, seconds=time.perf_counter() - t0)


def elastic_phase(amg: dict, on_card: bool, out_dir) -> dict:
    """The elastic runtime on the paper problem (the AMG phases' host
    hierarchy and right-hand side), float64, ``auto`` under ``LASSEN``,
    each configuration in its own fresh ``PlanCache`` (the earlier phases
    filled the default one with this hierarchy's 8-rank patterns).

    Flat/off and blocked/off: 3 V-cycles on 8 ranks, a heartbeat shrink to
    4 (``repartition``: cold), 3 more V-cycles from the 8-rank iterate,
    within 1e-12 of a cold 4-rank solve of 6; a grow-back to 8 that must
    re-plan and re-bind nothing, whose 6-V-cycle solve is within 1e-10 of
    the cold 8-rank one and launches ``VCYCLE_LAUNCHES`` a V-cycle.  On the
    flat one also the checkpoint (:func:`elastic_checkpoint`), the
    straggler (:func:`straggler_part`) and two planted faults: a grow-back
    through a fresh cache must read cold, and a resume from an iterate in
    the 8-rank packed layout must miss the 1e-12 bar."""
    import shutil

    import numpy as np

    from repro_torch.amg import DistributedHierarchy
    from repro_torch.core import PlanCache
    from repro_torch.core.costmodel import LASSEN
    from repro_torch.kernels import LAUNCHES
    from repro_torch.runtime import CheckpointManager
    from repro_torch.sparse.device import pack_vector

    host = amg["host"]
    h, b, device, bc = host["h"], host["b"], host["device"], host["block_cols"]
    t_phase = time.perf_counter()
    start = dict(LAUNCHES)
    out: dict = {"configs": {}, "planted": {}}
    K, M = ELASTIC_K, ELASTIC_M
    for variant, overlap in ELASTIC_CONFIGS:
        config = (variant, overlap)
        tag = f"elastic {variant}/{overlap}"
        cache = PlanCache()

        def setup(n: int, c):
            return DistributedHierarchy.setup(
                h, n, strategy="auto", params=LASSEN, cache=c,
                spmv_variant=variant, spmv_overlap=overlap,
                spmv_block_cols=bc, device=device)

        t0 = time.perf_counter()
        dh8 = setup(N_PROCS, cache)
        setup_s = time.perf_counter() - t0
        x_mid, _ = elastic_solve(dh8, b, K)
        x8_cold, _ = elastic_solve(dh8, b, K + M)
        offs8 = dh8.levels[0].A.part.offsets
        dh4 = dh8.repartition(n_procs=ELASTIC_SHRINK_TO, reason="heartbeat")
        del dh8                          # the 8-rank hierarchy is gone
        shrink = dh4.last_resize
        log(f"{tag}: cold 8-rank set-up {setup_s:.2f} s; shrink: {shrink}")
        if not (shrink.old_n == N_PROCS and shrink.new_n == ELASTIC_SHRINK_TO
                and shrink.plan_misses > 0):
            fail(f"{tag}: the first 4-rank build must plan: {shrink}")
        x_el, launches4 = elastic_solve(dh4, b, M, x0=x_mid)
        dh4_cold = setup(ELASTIC_SHRINK_TO, PlanCache())
        x4_cold, _ = elastic_solve(dh4_cold, b, K + M)
        del dh4_cold
        err = max_rel(x_el, x4_cold)
        log(f"{tag}: resumed on 4 ranks vs a cold 4-rank solve of {K + M} "
            f"V-cycles: max rel err {err:.3e} (bar {ELASTIC_SHRINK_TOL}); "
            f"launches per V-cycle on 4 ranks "
            f"{ {k: n / M for k, n in launches4.items()} } beside 8 ranks' "
            f"{VCYCLE_LAUNCHES[config]}")
        if not err < ELASTIC_SHRINK_TOL:
            fail(f"{tag}: the resumed solve is {err:.3e} off the cold one")
        if on_card and set(VCYCLE_LAUNCHES[config]) - set(launches4):
            fail(f"{tag}: kernels not launched on 4 ranks: {launches4}")
        rec = dict(setup_s=setup_s, shrink=dataclasses.asdict(shrink),
                   shrink_err=err, launches4={k: n / M for k, n in
                                              launches4.items()})
        if variant == "flat":
            ckpt_dir = Path(out_dir) / "elastic_ckpt"
            shutil.rmtree(ckpt_dir, ignore_errors=True)
            mgr = CheckpointManager(str(ckpt_dir), keep=2, async_save=True)
            try:
                rec["checkpoint"] = elastic_checkpoint(
                    mgr, x_mid, K, device,
                    lambda x0: bool(np.array_equal(
                        elastic_solve(dh4, b, M, x0=x0)[0], x_el)),
                    CKPT_BF16_SHAPE if on_card else (4, 64, 32))
            finally:
                shutil.rmtree(ckpt_dir, ignore_errors=True)
            if not rec["checkpoint"]["resumed"]:
                fail(f"{tag}: resuming from the checkpoint is not bitwise "
                     "the shrink's resumed iterate")
            log(f"{tag}: checkpoint of the 8-rank iterate and a bf16 "
                f"w_gate "
                f"({rec['checkpoint']['bytes'] / 1e6:.1f} MB) saved "
                f"asynchronously and restored bitwise in "
                f"{rec['checkpoint']['seconds']:.2f} s; resumed on 4 ranks: "
                "bitwise the shrink's iterate")
            # planted: the 8-rank iterate packed under the 8-rank offsets
            # at the 4-rank pad, handed over as a global vector
            bad = pack_vector(offs8, dh4.levels[0].pad,
                              x_mid).reshape(-1)[:len(x_mid)]
            x_bad, _ = elastic_solve(dh4, b, M, x0=bad)
            e_bad = max_rel(x_bad, x4_cold)
            out["planted"]["x0 in the 8-rank layout"] = e_bad
            if e_bad < ELASTIC_SHRINK_TOL:
                fail(f"{tag}: a resume from the 8-rank layout passes "
                     f"({e_bad:.3e})")
            log(f"{tag} refuses a planted fault, x0 packed under the 8-rank "
                f"offsets at the 4-rank pad: max rel err {e_bad:.3e}")
            # planted: a grow-back through a fresh cache must read cold
            real_cache, dh4.cache = dh4.cache, PlanCache()
            try:
                fresh = dh4.repartition(n_procs=N_PROCS,
                                        reason="requested").last_resize
            finally:
                dh4.cache = real_cache
            out["planted"]["grow-back through a fresh cache"] = str(fresh)
            if fresh.warm or fresh.plan_misses == 0:
                fail(f"{tag}: a grow-back through a fresh cache reads warm")
            log(f"{tag} refuses a planted fault, a grow-back through a "
                f"fresh cache: {fresh}")
        dh8b = dh4.repartition(n_procs=N_PROCS, reason="requested")
        del dh4
        grow = dh8b.last_resize
        log(f"{tag}: grow-back: {grow}")
        if not (grow.plan_misses == 0 and grow.exec_misses == 0
                and grow.plan_hits > 0 and grow.warm):
            fail(f"{tag}: the grow-back is not warm: {grow}")
        x_back, launches8 = elastic_solve(dh8b, b, K + M)
        err2 = max_rel(x_back, x8_cold)
        per8 = {k: n / (K + M) for k, n in launches8.items()}
        log(f"{tag}: grown back, {K + M} V-cycles vs the cold 8-rank solve: "
            f"max rel err {err2:.3e} (bar {ELASTIC_GROW_TOL}); launches per "
            f"V-cycle {per8}; replan s cold {shrink.replan_seconds:.3f}, "
            f"warm {grow.replan_seconds:.3f}")
        if not err2 < ELASTIC_GROW_TOL:
            fail(f"{tag}: the grown-back solve is {err2:.3e} off")
        if on_card and per8 != VCYCLE_LAUNCHES[config]:
            fail(f"{tag}: launches per V-cycle {per8}, expected "
                 f"{VCYCLE_LAUNCHES[config]}")
        rec.update(grow=dataclasses.asdict(grow), grow_err=err2,
                   launches8=per8)
        if variant == "flat":
            rec["straggler"] = straggler_part(dh8b, h, b, cache, on_card)
        del dh8b
        out["configs"][config] = rec
    out["launches"] = {k: LAUNCHES[k] - start[k] for k in LAUNCHES}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"elastic: launches in the phase {out['launches']}; phase "
        f"{out['seconds']:.1f} s")
    return out


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
# the modes' cap_factor: every mode claims capacity slots in the same
# token-major order, so where an expert overflows they drop the same pairs
# and compute one function (left pads, one token repeated, can overflow an
# expert: DeepSeek's 8 x 6 / 64 slots a token fall short of one a token)
AMPLE_CAP = 8.0


def no_drop_cap(cfg) -> float:
    """The cap_factor at which no pair can drop: each expert gets capacity
    for every token of a lane (a token picks an expert at most once)."""
    return cfg.n_experts / cfg.top_k
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
        """K7's call as ``ops.attention`` makes it: each kv head repeated
        over its group of query heads, (batch, heads) flattened."""
        B, H, Tq, d = q.shape
        Tk, group = k.shape[2], H // k.shape[1]
        kv_len, scale = kw.get("kv_len"), kw.get("scale")
        kr, vr = (k.repeat_interleave(group, dim=1),
                  v.repeat_interleave(group, dim=1)) if group > 1 else (k, v)
        record("flash_attention_bh", dict(
            q=q.reshape(B * H, Tq, d), k=kr.reshape(B * H, Tk, d),
            v=vr.reshape(B * H, Tk, d),
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
def routing(decisions: list, replay: bool, relay=None):
    """Record the MoE router's decisions (``moe.route``'s expert ids,
    weights and aux loss, call by call) while the block runs, or replay
    recorded ones in the same order.  Replaying still runs the router and
    counts the (lane, token) rows whose own expert ids differ from the
    recorded ones.  ``relay(recorded, own)`` moves a recorded decision
    onto this run's lanes (:func:`relaid`) before it is replayed."""
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
        if relay is not None:
            rec = relay(rec, own)
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


@contextlib.contextmanager
def moe_layer_calls(calls: list):
    """Record the models' MoE layer calls (``lm.moe_layer``'s arguments,
    keywords, output and dropped fraction) while the block runs."""
    from repro_torch.models import lm

    real = lm.moe_layer

    def record(*args, **kw):
        out = real(*args, **kw)
        calls.append((args, kw, out[0], float(out[2])))
        return out

    lm.moe_layer = record
    try:
        yield calls
    finally:
        lm.moe_layer = real


def relaid(src, dst, B: int, S: int):
    """``relay`` for :func:`routing`: a recorded decision of a batch of B
    sequences of S tokens, taken on the lanes of mesh ``src``, laid out on
    those of mesh ``dst``.  ``moe_layer`` splits the batch over the batch
    devices and each shard's B / n tokens, in order, over the ``model``
    lanes, padded to a multiple of them; the pad rows, which hold no token,
    keep the replaying run's own decision."""
    def layout(mesh):
        pm = mesh.axes["model"]
        nb = mesh.size // pm
        if B % nb:
            fail(f"relaid: batch {B} not split over {nb} batch devices")
        n_all = B // nb * S
        return nb, n_all, n_all + (-n_all) % pm

    def tokens(t, mesh):                 # [G, n_lane, ...] -> [B * S, ...]
        nb, n_all, n_pad = layout(mesh)
        tail = t.shape[2:]
        return t.reshape((nb, n_pad) + tail)[:, :n_all].reshape(
            (B * S,) + tail)

    def lanes(t, own, mesh):             # [B * S, ...] -> own's layout
        nb, n_all, n_pad = layout(mesh)
        tail = own.shape[2:]
        out = own.reshape((nb, n_pad) + tail).clone()
        out[:, :n_all] = t.reshape((nb, n_all) + tail)
        return out.reshape(own.shape)

    def relay(rec, own):
        return (lanes(tokens(rec[0], src), own[0], dst),
                lanes(tokens(rec[1], src), own[1], dst), own[2])

    return relay


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
    # the mask broadcasts to [Tq, Tk]: without causal or window it is one
    # row that every query shares
    pairs = int(attention_mask(Tq, k.shape[1], a["causal"], a["window"],
                               a["kv_len"], a["q_offset"], q.device)
                .expand(Tq, k.shape[1]).sum())
    if name == BWD:
        # q, o, dO and lse in, dq out; k, v in, dk, dv out; five products
        return (4 * BH * Tq * d * es + 4 * BH * Tq + 4 * BH * keys * d * es,
                10 * BH * pairs * d)
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
    if name == BWD:
        return fa_ops.flash_attention_bh_bwd(
            a["q"], a["k"], a["v"], a["o"], a["lse"], a["do"],
            scale=a["scale"], causal=a["causal"], window=a["window"])
    return fa_ops.flash_attention_bh(
        a["q"], a["k"], a["v"], scale=a["scale"], causal=a["causal"],
        window=a["window"], kv_len=a["kv_len"], q_offset=a["q_offset"])


def serve_plain_call(name: str, a: dict, operand=None):
    """The plain version of the call; ``operand`` as K7's and K8's plain
    versions take it (applied to their fp32 product operands)."""
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bh_bwd_ref,
        flash_attention_bh_ref,
    )
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
    if name == BWD:
        return flash_attention_bh_bwd_ref(
            a["q"], a["k"], a["v"], a["o"], a["lse"], a["do"],
            scale=a["scale"], causal=a["causal"], window=a["window"])
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
    if name == BWD:
        # sdpa's backward alone: its forward's graph built here, the
        # gradient taken in the call (the causal mask as is_causal, so
        # that sdpa may take its fused kernels)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        plain_causal = a["causal"] and not a["window"] \
            and q.shape[1] == k.shape[1]
        out = tf.scaled_dot_product_attention(
            qg, kg, vg, attn_mask=None if plain_causal else mask,
            is_causal=plain_causal, scale=a["scale"])
        return lambda: torch.autograd.grad(out, (qg, kg, vg), a["do"],
                                           retain_graph=True)
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
    :func:`device_times` on the next of the :func:`cold_copies`; the
    kernel's also by :func:`slept_event_ms`, ``slept_ms``) and the
    kernel's host us per call."""
    import torch

    nbytes, flops = serve_work(name, a)
    dname = str(a["buf" if name == "combine_rows" else "q"
                  if name.startswith("flash") else "x"].dtype).split(".")[1]
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
        slept_ms=slept_event_ms(fns["kernel"], 20) if on_card else None,
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
            f"{a['kv_len']} q_offset {a['q_offset']}"
            + (f" window {a['window']}" if a["window"] else ""))


def serve_kernel_phase(recorded: dict, on_card: bool) -> dict:
    """Every recorded K5-K8 call of one prefill and one decode step against
    its plain version; the largest prefill and decode call of each kernel
    (by bytes, then operations) timed.  Returns per kernel its largest
    prefill call's record, the decode record beside it."""
    results: dict = {}
    largest: dict = {}
    for (name, phase, *_), (n_calls, args) in recorded.items():
        rec = results.setdefault(name, {"max_abs_err": 0.0, "checked": 0})
        for a in args:
            rec["max_abs_err"] = max(rec["max_abs_err"],
                                     check_serve_call(name, a, phase))
            rec["checked"] += 1
            size = serve_work(name, a)
            if size > largest.get((name, phase), ((-1, -1), None))[0]:
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
            f"{fmt_ms(t['library_device_ms'])}; CUDA events behind a "
            f"device sleep {fmt_ms(t['slept_ms'])}), host us per call "
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


# ------------------------------------------------------- dense serve phase
# served through ServeEngine at full width and depth: gemma3-1b (d 256,
# one kv head, 5 local layers at window 512 : 1 global) and qwen2-0.5b
# (d 64, 14 query heads over 2 kv heads: a GQA group of 7)
DENSE_ARCHS = ("gemma3-1b", "qwen2-0.5b")
# at full width with the depth cut to DENSE_CUT_LAYERS: one prefill and
# DENSE_CUT_STEPS decode steps each, held to the plain K7 (d 128 both;
# qwen2-vl-2b carries the vlm family's M-RoPE)
DENSE_CUT_ARCHS = ("nemotron-4-15b", "qwen2-vl-2b")
DENSE_CUT_LAYERS = 4
DENSE_CUT_STEPS = 4
# K7's bf16 causal prefill at one T and two BH for each head dim, so only
# d changes within a BH: 16 (gemma3's prefill grid, 288 row blocks) and 7
# (126 row blocks, one an SM at every d); PROBE_REPS calls back to back
# between two CUDA events
PROBE_HEAD_DIMS = (64, 128, 192, 256)
PROBE_REPS = 8


def dense_sizes(on_card: bool) -> dict:
    """Six requests on four slots (3 prefills, 16 decode steps), every
    prompt longer than gemma3's window (512; 16 in the reduced config), so
    each local layer's cache starts full and rolls at every decode step;
    and the cut models' one batch (``cut_batch`` rows of ``cut_prompt``
    tokens).  Off the card, the CPU rehearsal's sizes."""
    if on_card:
        return dict(slots=4, max_len=1280,
                    prompts=(520, 1100, 760, 640, 980, 830),
                    new=(8, 12, 10, 6, 8, 8), cut_batch=2, cut_prompt=600,
                    probe_bh=(16, 7), probe_t=1100)
    return dict(slots=4, max_len=48, prompts=(20, 30, 24, 18, 27, 22),
                new=(3, 4, 2, 3, 4, 2), cut_batch=2, cut_prompt=20,
                probe_bh=(2,), probe_t=40)


def dense_faults(cfg) -> dict:
    """The dense model bound to K7 with a fault planted in the binding (the
    source untouched), one for each served model's path: gemma3's local
    layers at window 0 (every earlier key seen, not the last ``window``);
    for a model without windows (qwen2-0.5b, whose caches hold max_len
    slots), a decode call that takes its cache as full (kv_len = Tk,
    q_offset = Tk - 1), so it reads the unfilled slots."""
    from repro_torch.kernels.flash_attention import attention

    def window_zero(q, k, v, **kw):
        return attention(q, k, v, **dict(kw, window=0))

    def reads_unfilled(q, k, v, **kw):
        if q.shape[2] != 1:
            return attention(q, k, v, **kw)
        Tk = k.shape[2]
        return attention(q, k, v, **dict(kw, kv_len=Tk, q_offset=Tk - 1))

    if cfg.window:
        return {"K7 at window 0 on the local layers": bound_kernels(
            flash=window_zero)}
    return {"K7's decode reads the unfilled cache slots (kv_len = Tk)":
            bound_kernels(flash=reads_unfilled)}


def free_card(on_card: bool) -> None:
    """Collect the garbage and hand the freed blocks back to the card."""
    import torch

    gc.collect()
    if on_card:
        torch.cuda.empty_cache()


def draw_dense(cfg, device: str, on_card: bool):
    """(model, params) of ``cfg`` drawn on ``device`` from ``SERVE_SEED``,
    described in one line."""
    import torch

    from repro_torch.models import Model

    t0 = time.perf_counter()
    model = Model(cfg, device=device)
    params = model.init_params(seed=SERVE_SEED)
    card_sync(on_card)
    n_params, n_bytes = count_params(params)
    n_local = cfg.n_layers - model.windows.count(0)
    log(f"dense: {cfg.name}, {cfg.n_layers} layers ("
        + (f"{n_local} at window {cfg.window}, "
           f"{cfg.n_layers - n_local} global" if n_local else "all global")
        + f"), d_model {cfg.d_model}, {cfg.n_heads} query heads "
        f"over {cfg.n_kv_heads} kv heads of {cfg.head_dim}, vocab "
        f"{cfg.vocab}, {cfg.act}, {cfg.dtype}; {n_params:,} parameters, "
        f"{n_bytes / 1e9:.2f} GB on {device}, drawn in "
        f"{time.perf_counter() - t0:.2f} s"
        + (f"; {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated"
           if on_card else ""))
    return model, params, n_params, n_bytes


def dense_engine_run(cfg, device: str, on_card: bool, sizes: dict) -> dict:
    """One dense model served: six requests through ``ServeEngine``, K7's
    calls and CUDA launches per prefill and decode step (on the card
    n_layers each, a decode call two launches), every engine call replayed
    through the plain K7 in bf16 (logits within ``LOGIT_TOL``, no
    clear-margin greedy flip) and under its planted fault (refused), every
    K7 call of one prefill and one decode step against the plain version,
    the largest timed (and, with windows, the largest windowed prefill
    call)."""
    import torch

    from repro_torch.kernels import CUDA_LAUNCHES, LAUNCHES, reset_launches
    from repro_torch.serve import ServeEngine

    name = "flash_attention_bh"
    model, params, n_params, n_bytes = draw_dense(cfg, device, on_card)
    warm_up(model, params, sizes)
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
    check_served(done, sizes, cfg.vocab, f"dense {cfg.name}")
    summ = serve_summary(calls, (name,))
    summ.update(wall_s=wall, tokens={r.rid: r.generated for r in done},
                launches=LAUNCHES[name], cuda_launches=CUDA_LAUNCHES[name],
                n_params=n_params, n_bytes=n_bytes)
    log(f"dense {cfg.name}: {len(done)} requests in {wall:.2f} s; "
        f"{summ['prefills']} prefills, {summ['prefill_tokens']} tokens, "
        f"{summ['prefill_tok_s']:.1f} prefill tokens/s; "
        f"{summ['decode_steps']} decode steps, {summ['decode_ms']:.3f} ms "
        f"per step; K7 calls per prefill "
        f"{summ['launches_per_prefill'][name]:g}, per decode step "
        f"{summ['launches_per_decode'][name]:g} (CUDA launches "
        f"{summ['cuda_launches_per_prefill'][name]:g} and "
        f"{summ['cuda_launches_per_decode'][name]:g})")
    if on_card:
        L = cfg.n_layers
        for key, want in (("launches_per_prefill", L),
                          ("cuda_launches_per_prefill", L),
                          ("launches_per_decode", L),
                          ("cuda_launches_per_decode", 2 * L)):
            if summ[key][name] != want:
                fail(f"dense {cfg.name}: K7 {key} {summ[key][name]}, "
                     f"expected {want}")
    if not all(bool(torch.isfinite(c["logits"]).all()) for c in calls):
        fail(f"dense {cfg.name}: non-finite logits")

    res = replay_plain(model, params, eng, calls, [], on_card,
                       faults=dense_faults(cfg))
    summ.update(res)
    log(f"oracle dense {cfg.name}: {len(calls)} engine calls through the "
        "plain K7 in bf16; max |logit diff| / max |logit| "
        f"{res['oracle_rel_err']:.3e} (tolerance {LOGIT_TOL}); greedy "
        f"tokens equal on all {res['oracle_sure']} of {res['oracle_rows']} "
        "rows with a top-2 margin above it")
    for fault, got in res["planted"].items():
        log(f"oracle dense {cfg.name} refuses a planted fault, {fault}: max "
            f"|logit diff| / max |logit| {got['rel_err']:.3e}, greedy tokens "
            f"differ on {got['differ']} of {got['sure']} rows with a clear "
            "margin")

    kernel = serve_kernel_phase(recorded, on_card)[name]
    windowed = [a for (_, phase, *_), (_, args) in recorded.items()
                if phase == "prefill" for a in args if a["window"] > 0]
    if windowed:
        a = max(windowed, key=lambda a: serve_work(name, a))
        t = time_serve_call(name, a, on_card)
        log(f"  {name} largest windowed prefill call "
            f"({serve_call_shape(name, a)}, "
            f"{t['mbytes']:.2f} MB, {t['gflop']:.3f} GFLOP): kernel "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}); device ms from a cold L2 "
            f"{fmt_ms(t['device_ms'])} (library "
            f"{fmt_ms(t['library_device_ms'])}; CUDA events behind a "
            f"device sleep {fmt_ms(t['slept_ms'])}), host us per call "
            f"{fmt_ms(t['host_us'])}")
        kernel["window_prefill"] = t
    recorded.clear()
    if on_card:
        summ["profile"] = prof = profile_serve(model, params, sizes, on_card)
        log(f"dense {cfg.name} profile (4 requests): wall "
            f"{prof['wall_ms']:.1f} ms, device busy {prof['busy_ms']:.1f} "
            f"ms, idle share {prof['idle_share']:.3f}, "
            f"{prof['device_ops']} device ops; most device ms: "
            f"{prof['top_device']}")
    del params, model, eng, calls
    free_card(on_card)
    return dict(summary=summ, kernel=kernel)


def vlm_positions(B: int, T: int, device):
    """Qwen2-VL's M-RoPE ids for an image of T // 2 patches on a grid 16
    wide (time 0, row, column) followed by T - T // 2 text tokens (all
    three rows the text position): [B, 3, T], the rows differing."""
    import torch

    n_img = T // 2
    i = torch.arange(n_img)
    img = torch.stack([torch.zeros_like(i), i // 16, i % 16])
    text = (int(img.max()) + 1 + torch.arange(T - n_img)).expand(3, -1)
    return torch.cat([img, text], dim=1).expand(B, 3, T).to(
        device, torch.int32).contiguous()


def dense_cut_run(cfg, device: str, on_card: bool, sizes: dict) -> dict:
    """A dense or vlm model at full width and ``DENSE_CUT_LAYERS`` layers:
    one prefill (token ids; for the vlm precomputed embeddings at
    :func:`vlm_positions`) and ``DENSE_CUT_STEPS`` greedy decode steps
    through the kernels, then again through the plain K7 fed the same
    tokens: logits within ``LOGIT_TOL`` with no clear-margin greedy flip;
    every K7 call of the prefill and of the first decode step against the
    plain version, the largest of each timed."""
    import torch

    from repro_torch.kernels import CUDA_LAUNCHES, LAUNCHES, reset_launches
    from repro_torch.models import serving

    name = "flash_attention_bh"
    depth = cfg.n_layers
    cfg = dataclasses.replace(cfg, n_layers=min(depth, DENSE_CUT_LAYERS))
    model, params, n_params, n_bytes = draw_dense(cfg, device, on_card)
    B, T = sizes["cut_batch"], sizes["cut_prompt"]
    gen = torch.Generator().manual_seed(SERVE_SEED)
    if cfg.family == "vlm":
        inputs = {"embeds": torch.randn(B, T, cfg.d_model, generator=gen)
                  .to(device, cfg.dtype),
                  "positions": vlm_positions(B, T, device)}
    else:
        inputs = {"tokens": torch.randint(0, cfg.vocab, (B, T), generator=gen,
                                          dtype=torch.int32).to(device)}
    recorded: dict = {}

    def drive(binding, feed=None, record=False):
        """The prefill and the decode steps under ``binding``, fed
        ``feed`` (else the greedy tokens): (logits, tokens fed)."""
        out, fed = [], []
        with binding:
            with (recording_serve_kernel_calls(recorded, "prefill")
                  if record else contextlib.nullcontext()):
                logits, caches = serving.prefill(model, params, inputs,
                                                 max_len=sizes["max_len"])
            out.append(logits.float().cpu())
            for s in range(DENSE_CUT_STEPS):
                tok = (feed[s] if feed is not None else torch.argmax(
                    logits, -1).to(torch.int32)[:, None])
                fed.append(tok)
                with (recording_serve_kernel_calls(recorded, "decode")
                      if record and s == 0 else contextlib.nullcontext()):
                    logits, caches = serving.decode_step(
                        model, params, {"tokens": tok}, caches, T + s)
                out.append(logits.float().cpu())
        card_sync(on_card)
        return out, fed

    drive(contextlib.nullcontext())                 # first launches
    reset_launches()
    t0 = time.perf_counter()
    got, fed = drive(contextlib.nullcontext(), record=True)
    wall = time.perf_counter() - t0
    launches, cuda = LAUNCHES[name], CUDA_LAUNCHES[name]
    L = cfg.n_layers
    want = (L * (1 + DENSE_CUT_STEPS), L * (1 + 2 * DENSE_CUT_STEPS))
    if on_card and (launches, cuda) != want:
        fail(f"dense {cfg.name}: K7 calls and CUDA launches "
             f"{(launches, cuda)}, expected {want}")
    plain, _ = drive(plain_kernels(), feed=fed)
    if not all(bool(torch.isfinite(lg).all()) for lg in got + plain):
        fail(f"dense {cfg.name}: non-finite logits")
    res = compare_logits(got, plain)
    if not res["rel_err"] <= LOGIT_TOL or res["differ"]:
        fail(f"dense {cfg.name}: logits {res['rel_err']:.3e} of their max "
             f"off the plain K7 (tolerance {LOGIT_TOL}), greedy tokens "
             f"differ on {res['differ']} clear-margin rows")
    kernel = serve_kernel_phase(recorded, on_card)[name]
    what = ("embeddings, M-RoPE rows differing" if cfg.family == "vlm"
            else "tokens")
    log(f"dense {cfg.name} ({L} of {depth} layers): a prefill of {B} x {T} "
        f"{what} and {DENSE_CUT_STEPS} decode steps in {wall:.2f} s; K7 "
        f"calls {launches} (CUDA launches {cuda}); against the plain K7: "
        f"max |logit diff| / max |logit| {res['rel_err']:.3e} (tolerance "
        f"{LOGIT_TOL}), greedy tokens equal on all {res['sure']} of "
        f"{res['rows']} rows with a clear margin")
    recorded.clear()
    del params, model, inputs
    free_card(on_card)
    return dict(launches=launches, cuda_launches=cuda, wall_s=wall,
                n_params=n_params, n_bytes=n_bytes,
                oracle_rel_err=res["rel_err"], oracle_sure=res["sure"],
                oracle_rows=res["rows"], kernel=kernel)


def head_dim_probe(device: str, on_card: bool, sizes: dict) -> list:
    """K7's bf16 causal prefill on seeded q / k / v of ``probe_t`` rows at
    each BH of ``probe_bh`` and each of ``PROBE_HEAD_DIMS``: within a BH
    the grid is the same and only d changes (with it the shared memory a
    block, so blocks an SM, and the registers: d 192 and 256 spill), so
    the device time per FLOP tells what a larger d costs.  Each call held
    to the plain version (:func:`check_serve_call`); device ms by the
    profiler (:func:`device_times`, None where it records nothing) and by
    CUDA events behind a device sleep around ``PROBE_REPS`` calls back to
    back, per call; warm L2."""
    import torch

    name = "flash_attention_bh"
    T = sizes["probe_t"]
    out = []
    for BH in sizes["probe_bh"]:
        for d in PROBE_HEAD_DIMS:
            gen = torch.Generator().manual_seed(SERVE_SEED + d)
            q, k, v = (torch.randn(BH, T, d, generator=gen).to(
                device, torch.bfloat16) for _ in range(3))
            a = dict(q=q, k=k, v=v, scale=d ** -0.5, causal=True, window=0,
                     kv_len=T, q_offset=0)
            err = check_serve_call(name, a, f"head-dim probe d {d}")
            nbytes, flops = serve_work(name, a)

            def call(a=a):
                return serve_kernel_call(name, a)

            dev_ms = device_times({"kernel": call}, on_card)["kernel"][0]
            ev_ms = (slept_event_ms(
                lambda: [call() for _ in range(PROBE_REPS)], 10) / PROBE_REPS
                if on_card else None)
            rate = {by: None if t is None else flops / t / 1e9
                    for by, t in (("device", dev_ms), ("events", ev_ms))}
            out.append(dict(bh=BH, t=T, d=d, gflop=flops / 1e9,
                            mbytes=nbytes / 1e6, max_abs_err=err,
                            device_ms=dev_ms, event_ms=ev_ms,
                            device_tflops=rate["device"],
                            event_tflops=rate["events"]))
            log(f"  {name} head-dim probe [{BH}, {T}, {d}] causal: "
                f"{flops / 1e9:.3f} GFLOP, max |err| {err:.3e}; device ms "
                f"{fmt_ms(dev_ms)}, CUDA events {fmt_ms(ev_ms)} a call of "
                f"{PROBE_REPS}; TFLOP/s "
                + " / ".join("not measured" if r is None else f"{r:.1f}"
                             for r in rate.values()))
            del q, k, v, a
    return out


def dense_run(device: str = "cuda", reduced_config: bool = False) -> dict:
    """The dense serve phase (full configs on the card, the reduced ones
    for the CPU rehearsal): ``DENSE_ARCHS`` through the engine
    (:func:`dense_engine_run`), ``DENSE_CUT_ARCHS`` cut to
    ``DENSE_CUT_LAYERS`` layers (:func:`dense_cut_run`), then K7 at each
    head dim on one grid (:func:`head_dim_probe`).  Returns each model's
    record, K7's calls and CUDA launches over the phase and its record:
    the first served model's timed calls (each model's under ``by_arch``),
    the probe's (``head_dim_probe``) and the largest bf16 error of every
    model's checks."""
    from repro_torch import configs

    on_card = device == "cuda"
    get = configs.reduced if reduced_config else configs.get
    sizes = dense_sizes(on_card)
    t0 = time.perf_counter()
    served = {arch: dense_engine_run(get(arch), device, on_card, sizes)
              for arch in DENSE_ARCHS}
    cut = {arch: dense_cut_run(get(arch), device, on_card, sizes)
           for arch in DENSE_CUT_ARCHS}
    probe = head_dim_probe(device, on_card, sizes)
    name = "flash_attention_bh"
    kernel = dict(served[DENSE_ARCHS[0]]["kernel"])
    kernel["head_dim_probe"] = probe
    kernel["max_abs_err"] = max(r["kernel"]["max_abs_err"]
                                for r in (*served.values(), *cut.values()))
    kernel["by_arch"] = {arch: r["kernel"]
                         for arch, r in {**served, **cut}.items()}
    runs = [r["summary"] for r in served.values()] + list(cut.values())
    return dict(served=served, cut=cut, kernels={name: kernel},
                launches={name: sum(r["launches"] for r in runs)},
                cuda_launches={name: sum(r["cuda_launches"] for r in runs)},
                seconds=time.perf_counter() - t0)


# --------------------------------------------------------------- train phase
TRAIN_ARCH = "qwen2-0.5b"
BWD = "flash_attention_bh_bwd"
# K7's forward log-sum-exp against the plain version's, normwise over the
# rows that see a key (fp32 in both, from the same inputs)
LSE_TOL = 1e-5
# the float32 backward's tile sizes (cuda.BWD_ROWS, cuda.BWD_STEP: 32 rows
# a block, 64 or 32 a step) and the window its edge calls take
BWD_F32_TILES = (32, 64)
BWD_EDGE_WINDOW = 20
# K7's backward at calls the training path does not make: d 128, a
# window, non-causal, a ragged T, rows that see no key; T at each float32
# tile size - 1, + 0 and + 1, at d 64 and 128, causal without and with a
# window; and 420 blocks a pass, more than the 132 SMs x 3 of one wave;
# (BH, Tq, Tk, d, causal, window)
BWD_EDGE_CALLS = (
    (3, 100, 100, 64, True, 0),
    (2, 257, 257, 128, True, 0),
    (2, 130, 130, 64, True, 40),
    (2, 70, 45, 64, False, 0),
    (2, 90, 33, 128, False, 16),     # rows 48 on see no key
    *((2, t, t, d, True, w) for tile in BWD_F32_TILES
      for t in (tile - 1, tile, tile + 1) for d in (64, 128)
      for w in (0, BWD_EDGE_WINDOW)),
    (140, 96, 96, 64, True, 0),
)


# K7's float32 forward (attn_fwd_f32.cuh) at calls its path makes and does
# not (:func:`fwd_edge_calls`); the window its tile-edge calls take
FWD_EDGE_WINDOW = 20


@functools.cache
def fwd_edge_calls() -> tuple:
    """K7's float32 forward edge calls: T = Tq = Tk at each float32 tile
    size (``cuda.FWD_ROWS``, ``cuda.FWD_STEP``) - 1, + 0 and + 1, at every
    head dim the source builds, causal, causal with a window and
    non-causal; rows that see no key (48 on); kv_len < Tk with q_offset > 0
    (chunked prefill, a window too); d 112 ragged, d 256 non-causal with
    kv_len < Tk; and 720 blocks, more than the 132 SMs x 4 of one wave at
    d 64; (BH, Tq, Tk, d, causal, window, kv_len, q_offset)."""
    import torch

    from repro_torch.kernels.flash_attention import cuda as fa_cuda

    f32 = torch.float32
    tiles = sorted({fa_cuda.FWD_ROWS[f32], *fa_cuda.FWD_STEP[f32].values()})
    return (
        *((2, t, t, d, causal, w, t, 0) for tile in tiles
          for t in (tile - 1, tile, tile + 1) for d in fa_cuda.HEAD_DIMS
          for causal, w in ((True, 0), (True, FWD_EDGE_WINDOW), (False, 0))),
        (2, 90, 33, 128, False, 16, 33, 0),      # rows 48 on see no key
        (2, 17, 300, 128, True, 0, 201, 184),
        (2, 40, 120, 64, True, 0, 100, 60),
        (2, 16, 64, 192, True, 4, 44, 40),
        (2, 100, 150, 112, True, 0, 150, 0),
        (2, 33, 64, 256, False, 0, 50, 0),
        (180, 100, 100, 64, True, 0, 100, 0),
    )


def forward_lse(a: dict):
    """(out, lse) of the K7 forward call ``a`` (kv_len and q_offset where
    it names them, else all keys from position 0): the kernel on the
    card, the plain version off it."""
    from repro_torch.kernels import use_kernel
    from repro_torch.kernels.flash_attention import cuda as fa_cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_bh_ref

    q, k, v = (a[n].detach().contiguous() for n in ("q", "k", "v"))
    kv_len, q_offset = a.get("kv_len", k.shape[1]), a.get("q_offset", 0)
    if use_kernel(q, k, v):
        return fa_cuda.flash_attention_bh(q, k, v, a["scale"], a["causal"],
                                          a["window"], kv_len, q_offset,
                                          lse=True)
    return flash_attention_bh_ref(q, k, v, scale=a["scale"],
                                  causal=a["causal"], window=a["window"],
                                  kv_len=kv_len, q_offset=q_offset,
                                  return_lse=True)


def fwd_problems(got, a: dict):
    """(what is wrong, the output's error) of ``got`` = (out, lse) of the
    float32 forward call ``a`` against the plain version: the output
    normwise within ``SERVE_TOL["float32"]``, lse within ``LSE_TOL`` on
    the rows that see a key, the rows that see no key exactly 0 with an
    lse of +inf."""
    import torch

    from repro_torch.kernels.flash_attention.ref import flash_attention_bh_ref

    out, lse = got
    want, lse_ref = flash_attention_bh_ref(
        a["q"], a["k"], a["v"], scale=a["scale"], causal=a["causal"],
        window=a["window"], kv_len=a["kv_len"], q_offset=a["q_offset"],
        return_lse=True)
    seen = torch.isfinite(lse_ref)
    bad = []
    if out.shape != want.shape or out.dtype != want.dtype:
        return [f"out {tuple(out.shape)} {out.dtype}, expected "
                f"{tuple(want.shape)} {want.dtype}"], math.inf
    if not bool(torch.isfinite(out).all()):
        bad.append("non-finite output")
    err = rel_err(out, want)
    if not err <= SERVE_TOL["float32"]:
        bad.append(f"output {err:.3e} off the plain version's (tolerance "
                   f"{SERVE_TOL['float32']})")
    if not torch.equal(torch.isfinite(lse), seen):
        bad.append("lse infinite on other rows than the plain version's")
    else:
        lerr = rel_err(lse[seen], lse_ref[seen])
        if not lerr <= LSE_TOL:
            bad.append(f"lse {lerr:.3e} off (tolerance {LSE_TOL})")
    if not (bool((out[~seen] == 0).all())
            and bool((lse[~seen] == float("inf")).all())):
        bad.append("a row that sees no key is not 0 with an lse of +inf")
    return bad, err


def fwd_edge_checks(device, gen) -> float:
    """:func:`fwd_edge_calls` in float32 through K7's forward against the
    plain version (:func:`fwd_problems`), a rerun of each bitwise equal to
    the first; the planted fault (the plain forward with each row's last
    visible key dropped: kv_len - 1 on a non-causal call) refused by the
    same check.  Returns the largest output error."""
    import torch

    from repro_torch.kernels.flash_attention.ref import flash_attention_bh_ref

    worst = 0.0
    calls = fwd_edge_calls()
    for BH, Tq, Tk, d, causal, window, kv_len, q_offset in calls:
        q = torch.randn(BH, Tq, d, generator=gen).to(device)
        k, v = (torch.randn(BH, Tk, d, generator=gen).to(device)
                for _ in range(2))
        a = dict(q=q, k=k, v=v, scale=d ** -0.5, causal=causal,
                 window=window, kv_len=kv_len, q_offset=q_offset)
        label = (f"f32 edge [{BH}, {Tq}, {Tk}, {d}] "
                 + ("causal" if causal else "non-causal")
                 + (f" window {window}" if window else "")
                 + (f" kv_len {kv_len}" if kv_len < Tk else "")
                 + (f" q_offset {q_offset}" if q_offset else ""))
        got = forward_lse(a)
        bad, err = fwd_problems(got, a)
        if bad:
            fail(f"flash_attention_bh {label}: " + "; ".join(bad))
        again = forward_lse(a)
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            fail(f"flash_attention_bh {label}: a rerun differs from the "
                 "first run")
        worst = max(worst, err)
        if (BH, Tq, d, causal) == (2, 65, 64, False):
            fault, _ = fwd_problems(flash_attention_bh_ref(
                q, k, v, scale=a["scale"], causal=False, window=0,
                kv_len=kv_len - 1, return_lse=True), a)
            if not fault:
                fail(f"flash_attention_bh {label}: the planted fault (each "
                     "row's last visible key dropped) passes the check")
            log(f"kernel flash_attention_bh {label} refuses a planted "
                "fault, the plain forward with each row's last visible key "
                "dropped: " + "; ".join(fault))
    log(f"kernel flash_attention_bh f32 edge: {len(calls)} calls "
        f"within tolerance of the plain version (output within "
        f"{SERVE_TOL['float32']}, largest {worst:.3e}; lse within "
        f"{LSE_TOL}; rows that see no key 0 and +inf), reruns bitwise "
        "equal")
    return worst


def bwd_call(a: dict, do) -> dict:
    """The backward call of the forward call ``a`` (a prefill over all its
    keys from position 0) for the output's gradient ``do``: o and lse by
    :func:`forward_lse`."""
    o, lse = forward_lse(a)
    return dict(q=a["q"].detach(), k=a["k"].detach(), v=a["v"].detach(),
                o=o, lse=lse, do=do.detach(), scale=a["scale"],
                causal=a["causal"], window=a["window"],
                kv_len=a["k"].shape[1], q_offset=0)


def check_bwd_call(a: dict, label: str) -> float:
    """K7's forward lse (``LSE_TOL``) and backward (each of dq, dk, dv
    normwise within ``SERVE_TOL``) against their plain versions, in bf16
    and float32, on the call's q, k, v and do cast to each, o and lse
    from the kernel's forward in that dtype; returns the bf16 max
    |difference| of dq, dk, dv."""
    import torch

    from repro_torch.kernels.flash_attention.ref import flash_attention_bh_ref

    abs_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        ad = dict(a, **{n: a[n].detach().to(dtype)
                        for n in ("q", "k", "v", "do")})
        b = bwd_call(ad, ad["do"])
        _, lse_ref = flash_attention_bh_ref(
            ad["q"], ad["k"], ad["v"], scale=a["scale"], causal=a["causal"],
            window=a["window"], return_lse=True)
        seen = torch.isfinite(lse_ref)
        if not torch.equal(seen, torch.isfinite(b["lse"])):
            fail(f"{BWD} {label} {dname}: the forward's lse is infinite on "
                 "other rows than the plain version's")
        err = rel_err(b["lse"][seen], lse_ref[seen])
        if not err <= LSE_TOL:
            fail(f"{BWD} {label} {dname}: forward lse {err} off the plain "
                 f"version's (tolerance {LSE_TOL})")
        got, want = serve_kernel_call(BWD, b), serve_plain_call(BWD, b)
        for n, g, w in zip(("dq", "dk", "dv"), got, want):
            if g.shape != w.shape or g.dtype != w.dtype:
                fail(f"{BWD} {label} {dname} {n}: {tuple(g.shape)} {g.dtype}"
                     f" vs {tuple(w.shape)} {w.dtype}")
            if not bool(torch.isfinite(g).all()):
                fail(f"{BWD} {label} {dname} {n}: non-finite output")
            err = rel_err(g.float(), w.float())
            if not err <= SERVE_TOL[dname]:
                fail(f"{BWD} {label} {dname} {n}: max rel error {err} > "
                     f"{SERVE_TOL[dname]}")
            if dtype == torch.bfloat16 and g.numel():
                abs_err = max(abs_err, float(torch.max(torch.abs(
                    g.float() - w.float()))))
        if not bool((got[0][~seen] == 0).all()):
            fail(f"{BWD} {label} {dname}: a row that sees no key has a "
                 "nonzero dq")
    return abs_err


def bwd_edge_checks(device, gen) -> float:
    """``BWD_EDGE_CALLS`` against the plain versions (:func:`check_bwd_call`),
    a rerun of each bitwise equal to the first (the backward has no
    atomics), and the calls the backward does not take refused (a
    q_offset; kv_len < Tk; one query row); returns the bf16 max
    |difference|."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_bh

    err = 0.0
    for BH, Tq, Tk, d, causal, window in BWD_EDGE_CALLS:
        q, do = (torch.randn(BH, Tq, d, generator=gen).to(device)
                 for _ in range(2))
        k, v = (torch.randn(BH, Tk, d, generator=gen).to(device)
                for _ in range(2))
        a = dict(q=q, k=k, v=v, do=do, scale=d ** -0.5, causal=causal,
                 window=window, kv_len=Tk, q_offset=0)
        label = (f"edge [{BH}, {Tq}, {Tk}, {d}] "
                 + ("causal" if causal else "non-causal")
                 + (f" window {window}" if window else ""))
        err = max(err, check_bwd_call(a, label))
        b = bwd_call(a, do)
        first, again = serve_kernel_call(BWD, b), serve_kernel_call(BWD, b)
        if not all(torch.equal(x, y) for x, y in zip(first, again)):
            fail(f"{BWD} {label}: a rerun differs from the first run")
        log(f"kernel {BWD} {label}: within tolerance of its plain version "
            "in bf16 and float32, lse too; a rerun bitwise equal")
    for kw, Tq, Tk in ((dict(q_offset=3), 8, 11), (dict(kv_len=6), 8, 8),
                       (dict(), 1, 8)):
        q = torch.randn(2, Tq, 64, device=device, requires_grad=True)
        k = torch.randn(2, Tk, 64, device=device, requires_grad=True)
        what = f"Tq {Tq}, Tk {Tk}, {kw}"
        try:
            flash_attention_bh(q, k, k, scale=0.125, causal=True, **kw)
        except ValueError as e:
            log(f"kernel {BWD} edge    refuses a call it does not take "
                f"({what}): {e}")
            continue
        fail(f"{BWD}: a call ({what}) that wants a gradient was not "
             "refused")
    return err


def time_bwd_call(a: dict, on_card: bool) -> dict:
    """The backward call ``a`` timed as :func:`time_serve_call` times a
    serve call (kernel, plain, ``sdpa``'s backward, bound; device ms from
    a cold L2), with its forward beside it (kernel, plain, ``sdpa``)."""
    fwd = dict(q=a["q"], k=a["k"], v=a["v"], scale=a["scale"],
               causal=a["causal"], window=a["window"], kv_len=a["kv_len"],
               q_offset=0)
    out = time_serve_call(BWD, a, on_card)
    out["forward"] = time_serve_call("flash_attention_bh", fwd, on_card)
    return out


def log_timed(name: str, label: str, a: dict, t: dict) -> None:
    lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
    log(f"  {name} {label} ({serve_call_shape(name, a)} "
        f"{str(a['q'].dtype).split('.')[1]}, {t['mbytes']:.2f} MB, "
        f"{t['gflop']:.3f} GFLOP): kernel {t['ms']:.4f} ms, plain "
        f"{t['plain_ms']:.4f} ms, library {lib}, bound {t['bound_ms']:.4f} ms"
        f" ({t['bound_by']}); device ms from a cold L2 "
        f"({t['cold_copies']} copies) {fmt_ms(t['device_ms'])} (library "
        f"{fmt_ms(t['library_device_ms'])}; CUDA events behind a device "
        f"sleep {fmt_ms(t['slept_ms'])}), host us per call "
        f"{fmt_ms(t['host_us'])}")


TRAIN_SEED = 0
TRAIN_BWD_SOURCE = "src/repro_torch/csrc/flash_attention_bwd.cu"
# repro has no Pallas backward: its gradient through attention is jax's
# VJP of the chunked attention_ref
TRAIN_BWD_REPLACES = ("src/repro/kernels/flash_attention/ref.py:69 "
                      "attention_ref, by jax.vjp (no Pallas backward)")
# the launcher's loss must fall by this much (nats) over its steps
TRAIN_LOSS_DROP = 0.1
DP_METHODS = ("jit", "ring", "hier", "auto")
DP_LANES = 8
# a lane-step's loss and gradient through the kernels against the plain
# K7 (forward and backward bound to their plain versions): the loss
# relative, the gradient by its relative norm; float32 sums in other
# orders through 24 layers (7.6e-7 seen on the H100, and the planted
# backward fault 5.8e-4)
ORACLE_LOSS_TOL = 1e-5
ORACLE_GRAD_TOL = 1e-5


def train_sizes(on_card: bool) -> dict:
    """The launcher's run (batch x seq, steps, checkpoint every) and the
    DP step (lanes of one sequence each); off the card, the CPU
    rehearsal's sizes at the reduced config and vocab 128."""
    if on_card:
        return dict(batch=8, seq=1024, steps=6, ckpt_every=3,
                    lane_seq=1024, vocab=None)
    return dict(batch=4, seq=32, steps=6, ckpt_every=3, lane_seq=32,
                vocab=128)


def train_config(reduced_config: bool, sizes: dict):
    import torch

    from repro_torch import configs

    cfg = (configs.reduced if reduced_config else configs.get)(TRAIN_ARCH)
    if sizes["vocab"]:
        cfg = dataclasses.replace(cfg, vocab=sizes["vocab"])
    return dataclasses.replace(cfg, dtype=torch.float32)


def k7_counts() -> dict:
    from repro_torch.kernels import CUDA_LAUNCHES, LAUNCHES

    return {k: (LAUNCHES[k], CUDA_LAUNCHES[k])
            for k in ("flash_attention_bh", BWD)}


def k7_since(before: dict, per: int = 1) -> dict:
    """K7's forward and backward calls and CUDA launches since ``before``
    (:func:`k7_counts`), divided by ``per``."""
    now = k7_counts()
    return {k: ((now[k][0] - before[k][0]) / per,
                (now[k][1] - before[k][1]) / per) for k in now}


def check_k7_per_step(got: dict, n_layers: int, label: str,
                      on_card: bool) -> None:
    """With remat, K7's forward twice a layer (the forward and its
    recompute) and its backward once, a call one CUDA launch forward and
    three backward."""
    want = {"flash_attention_bh": (2 * n_layers, 2 * n_layers),
            BWD: (n_layers, 3 * n_layers)}
    if on_card and got != want:
        fail(f"train {label}: K7 (calls, CUDA launches) per step {got}, "
             f"expected {want}")


def launcher_part(cfg, device: str, on_card: bool, sizes: dict,
                  out_dir: Path, reduced_config: bool) -> dict:
    """``repro_torch.launch.train``'s main path: ``steps`` steps of
    batch x seq in float32 with remat, a checkpoint every ``ckpt_every``
    steps; then a run that died after the first checkpoint (a directory
    holding only it) resumes and must end bitwise on the uninterrupted
    run's parameters and optimizer state.  The loss must be finite and
    fall by ``TRAIN_LOSS_DROP``; K7 per step as :func:`check_k7_per_step`."""
    import shutil

    import torch

    from repro_torch.launch import train as launch
    from repro_torch.train.tree import tree_leaves

    B, S, N, every = (sizes[k] for k in ("batch", "seq", "steps",
                                         "ckpt_every"))
    args = ["--arch", TRAIN_ARCH, "--steps", str(N), "--batch", str(B),
            "--seq", str(S), "--ckpt-every", str(every), "--log-every", "1",
            "--device", device]
    if reduced_config:
        args += ["--reduced"]
    if sizes["vocab"]:
        args += ["--vocab", str(sizes["vocab"])]
    full_dir, died_dir = out_dir / "full", out_dir / "died"
    shutil.rmtree(out_dir, ignore_errors=True)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    start = before = k7_counts()
    t0 = time.perf_counter()
    full = launch.main(args + ["--ckpt", str(full_dir)])
    wall = time.perf_counter() - t0
    per_step = k7_since(before, N)
    check_k7_per_step(per_step, cfg.n_layers, "launcher", on_card)
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    hist = full["history"]
    losses = [h["loss"] for h in hist]
    if not all(map(math.isfinite, losses)):
        fail(f"train launcher: non-finite loss {losses}")
    if not losses[-1] < losses[0] - TRAIN_LOSS_DROP:
        fail(f"train launcher: the loss went {losses[0]:.4f} -> "
             f"{losses[-1]:.4f}, not down by {TRAIN_LOSS_DROP}")
    steady = sorted(h["seconds"] for h in hist[1:])
    step_s = steady[len(steady) // 2]
    tok_s = B * S / step_s
    first = f"step_{every:09d}"
    died_dir.mkdir(parents=True)
    shutil.copytree(full_dir / first, died_dir / first)
    (died_dir / "LATEST").write_text(first)
    before = k7_counts()
    t1 = time.perf_counter()
    resumed = launch.main(args + ["--ckpt", str(died_dir)])
    resume_wall = time.perf_counter() - t1
    check_k7_per_step(k7_since(before, N - every), cfg.n_layers,
                      "launcher resumed", on_card)
    k7 = k7_since(start)
    a, b = tree_leaves(full["state"]), tree_leaves(resumed["state"])
    same = len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))
    if resumed["start"] != every or not same:
        fail(f"train launcher: the run resumed from step "
             f"{resumed['start']} does not end bitwise on the "
             "uninterrupted run's state")
    log(f"train launcher: {cfg.name}, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab}, {full['n_params']:,} parameters"
        f" in float32, remat on; {N} steps of {B} x {S} tokens in "
        f"{wall:.1f} s (checkpoints every {every} steps included); loss "
        + " ".join(f"{x:.4f}" for x in losses)
        + f"; ms a step {step_s * 1e3:.1f} (median of steps 2-{N}), "
        f"{tok_s:,.0f} tokens/s; K7 a step: {per_step}; peak "
        + (f"{peak:.2f} GB" if peak is not None else "not measured")
        + f"; resumed from step {every} in {resume_wall:.1f} s, bitwise "
        f"equal ({len(a)} leaves)")
    shutil.rmtree(out_dir, ignore_errors=True)
    del full, resumed, a, b
    return dict(losses=losses, step_ms=step_s * 1e3, tokens_per_s=tok_s,
                steps_ms=[h["seconds"] * 1e3 for h in hist],
                wall_s=wall, resume_wall_s=resume_wall, per_step=per_step,
                peak_gb=peak, n_params=cfg.param_count(), k7=k7)


@contextlib.contextmanager
def bound_bwd(fn):
    """K7's backward call site (``ops.flash_attention_bh_bwd``, which the
    ``autograd.Function`` calls) bound to ``fn`` while the block runs."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    saved = fa_ops.flash_attention_bh_bwd
    fa_ops.flash_attention_bh_bwd = fn
    try:
        yield
    finally:
        fa_ops.flash_attention_bh_bwd = saved


def drops_last_key_tile(q, k, v, o, lse, do, **kw):
    """The planted backward fault: dK of the last 64-key tile left at
    zero."""
    from repro_torch.kernels.flash_attention import flash_attention_bh_bwd

    dq, dk, dv = flash_attention_bh_bwd(q, k, v, o, lse, do, **kw)
    dk = dk.clone()
    dk[:, (k.shape[1] - 1) // 64 * 64:] = 0
    return dq, dk, dv


def flat_grad(grads):
    from repro_torch.train.tree import ravel

    return ravel(grads)[0]


def oracle_part(model, params, shard: dict, on_card: bool,
                launcher_batch: int) -> dict:
    """One lane-step (loss and gradient of one sequence) through the
    kernels, its K7 calls recorded; again with K7's forward and backward
    bound to their plain versions (the model's ``attention.flash`` bound to
    ``attention_ref``, autograd of which is the plain backward): the loss
    within ``ORACLE_LOSS_TOL`` and the gradient's relative norm within
    ``ORACLE_GRAD_TOL``; and with dK's last key tile zeroed
    (:func:`drops_last_key_tile`), which the same check must refuse.
    Every distinct recorded K7 forward and backward call held to the plain
    versions in bf16 and float32; the backward's and forward's calls timed
    from a cold L2 (float32, the path's type, and bf16), and in float32 at
    the launcher's call, its ``launcher_batch`` sequences in one
    microbatch (seeded inputs of that shape)."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.train.trainer import value_and_grad

    def loss_fn(p, b):
        return model.loss(p, b)[0]

    recorded: dict = {}
    bwd_calls: list = []
    real_bwd = fa_ops.flash_attention_bh_bwd

    def recording_bwd(q, k, v, o, lse, do, **kw):
        bwd_calls.append(dict(q=q, k=k, v=v, o=o, lse=lse, do=do,
                              kv_len=k.shape[1], q_offset=0, **kw))
        return real_bwd(q, k, v, o, lse, do, **kw)

    before = k7_counts()
    with recording_serve_kernel_calls(recorded, "train"), \
            bound_bwd(recording_bwd):
        loss, g = value_and_grad(loss_fn, params, shard)
    card_sync(on_card)
    per_step = k7_since(before)
    check_k7_per_step(per_step, model.cfg.n_layers, "lane-step", on_card)
    g = flat_grad(g)
    with plain_kernels():
        loss_p, g_p = value_and_grad(loss_fn, params, shard)
    g_p = flat_grad(g_p)
    with bound_bwd(drops_last_key_tile):
        loss_f, g_f = value_and_grad(loss_fn, params, shard)
    g_f = flat_grad(g_f)

    def gap(x, y):
        return float(torch.linalg.vector_norm(x - y)
                     / torch.linalg.vector_norm(y))

    loss_err = abs(float(loss) - float(loss_p)) / abs(float(loss_p))
    grad_err, fault_err = gap(g, g_p), gap(g_f, g_p)
    if not (math.isfinite(float(loss)) and loss_err <= ORACLE_LOSS_TOL
            and grad_err <= ORACLE_GRAD_TOL):
        fail(f"train oracle: loss {float(loss)} vs plain {float(loss_p)} "
             f"(rel {loss_err:.3e}, tolerance {ORACLE_LOSS_TOL}); gradient "
             f"relative norm {grad_err:.3e} (tolerance {ORACLE_GRAD_TOL})")
    if not fault_err > ORACLE_GRAD_TOL:
        fail(f"train oracle: the planted fault (dK's last key tile at zero) "
             f"gives a gradient {fault_err:.3e} off the plain one, within "
             f"the tolerance {ORACLE_GRAD_TOL}: not refused")
    log(f"train oracle: a lane-step ({shard['tokens'].shape[1]} tokens) "
        f"through the kernels against K7 bound to its plain versions: "
        f"loss {float(loss):.6f} vs {float(loss_p):.6f} (rel {loss_err:.3e},"
        f" tolerance {ORACLE_LOSS_TOL}), gradient relative norm "
        f"{grad_err:.3e} (tolerance {ORACLE_GRAD_TOL}); K7 a lane-step "
        f"{per_step}")
    log(f"train oracle refuses a planted fault, K7's backward leaves dK of "
        f"its last key tile at zero: gradient relative norm {fault_err:.3e}")
    del g, g_p, g_f

    # every distinct K7 call of the lane-step against the plain versions
    kernels = {"flash_attention_bh": {"max_abs_err": 0.0, "checked": 0},
               BWD: {"max_abs_err": 0.0, "checked": 0}}
    fwd = {}
    for (name, phase, *_), (n, args) in recorded.items():
        a = {k: v.detach() if torch.is_tensor(v) else v
             for k, v in args[0].items()}
        err = check_serve_call(name, a, phase)
        kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], err)
        kernels[name]["checked"] += 1
        fwd[serve_call_shape(name, a)] = (a, n)
        log(f"kernel {name} train {serve_call_shape(name, a)}: {n} calls, "
            "within tolerance of its plain version in bf16 and float32")
    distinct = {}
    for c in bwd_calls:
        distinct.setdefault(serve_call_shape(BWD, c), (c, 0))
        distinct[serve_call_shape(BWD, c)] = (
            c, distinct[serve_call_shape(BWD, c)][1] + 1)
    for shape, (c, n) in distinct.items():
        a = {k: v.detach() if torch.is_tensor(v) else v for k, v in c.items()}
        err = check_bwd_call(a, "train")
        kernels[BWD]["max_abs_err"] = max(kernels[BWD]["max_abs_err"], err)
        kernels[BWD]["checked"] += 1
        log(f"kernel {BWD} train {shape}: {n} calls, within tolerance of "
            "its plain version in bf16 and float32, lse too")
    largest = max((c for c, _ in distinct.values()),
                  key=lambda c: serve_work(BWD, c))
    a = {k: v.detach() if torch.is_tensor(v) else v
         for k, v in largest.items()}
    t = time_bwd_call(a, on_card)
    log_timed(BWD, "lane-step call", a, t)
    log_timed("flash_attention_bh", "lane-step call (its forward)", a,
              t["forward"])
    bf = dict(a, **{n: a[n].to(torch.bfloat16)
                    for n in ("q", "k", "v", "do")})
    bf = bwd_call(bf, bf["do"])
    t16 = time_bwd_call(bf, on_card)
    log_timed(BWD, "lane-step call", bf, t16)
    log_timed("flash_attention_bh", "lane-step call (its forward)", bf,
              t16["forward"])
    BH, T, d = a["q"].shape
    gen = torch.Generator().manual_seed(TRAIN_SEED)
    q, k, v, do = (torch.randn(BH * launcher_batch, T, d, generator=gen)
                   .to(a["q"].device) for _ in range(4))
    la = bwd_call(dict(q=q, k=k, v=v, scale=a["scale"], causal=a["causal"],
                       window=a["window"], kv_len=T, q_offset=0), do)
    tl = time_bwd_call(la, on_card)
    log_timed(BWD, "launcher call", la, tl)
    log_timed("flash_attention_bh", "launcher call (its forward)", la,
              tl["forward"])
    del q, k, v, do, la
    kernels[BWD].update(t, bf16=t16, launcher=tl)
    kernels["flash_attention_bh"].update(train=t["forward"],
                                         train_bf16=t16["forward"],
                                         train_launcher=tl["forward"])
    recorded.clear()
    bwd_calls.clear()
    return dict(loss_err=loss_err, grad_err=grad_err, fault_err=fault_err,
                per_step=per_step, kernels=kernels)


def label_check(model, params, shard: dict, on_card: bool) -> dict:
    """One lane-step (loss and gradient through ``Model.loss``) on a
    sequence whose labels hold -1 and V, in the loss mask and out of it:
    the loss and gradient must be finite (such a label picks no logit, as
    in ``repro``), and the card must take work after it (a gather on such
    a label would trip a device-side assert)."""
    import torch

    from repro_torch.train.trainer import value_and_grad

    V = model.cfg.vocab
    labels = shard["labels"].clone()
    mask = torch.ones(labels.shape, dtype=torch.float32,
                      device=labels.device)
    labels[0, 1:5] = torch.tensor([-1, V, -1, V], dtype=labels.dtype)
    mask[0, 3:5] = 0.0
    b = dict(shard, labels=labels, loss_mask=mask)
    loss, g = value_and_grad(lambda p, x: model.loss(p, x)[0], params, b)
    g = flat_grad(g)
    finite = math.isfinite(float(loss)) and bool(torch.isfinite(g).all())
    card_sync(on_card)
    after = float(torch.ones(8, device=labels.device).sum())
    if not finite or after != 8.0:
        fail(f"train labels -1 and V: loss {float(loss)}, gradient finite "
             f"{bool(torch.isfinite(g).all())}, the card after it {after}")
    log(f"train labels -1 and V (two in the mask, two out of it): loss "
        f"{float(loss):.6f} and gradient finite; the card takes work after "
        "it")
    del g
    return dict(loss=float(loss))


def sync_check(rows, g, loss, label: str) -> dict:
    """The synced float32 gradient ``g`` (the optimizer's) and loss against
    the float64 mean of the lanes' ``rows`` ``[P, n + 1]``: elementwise
    within ``P 2^-24 mean_p |g_p|`` (the rounding of a P-term float32 sum
    and of its last division by P), the loss within 1e-6 relative; in
    column chunks, so that no float64 copy of the rows is made whole.
    Returns the worst excess over the bound (<= 0 within it), the
    violating elements and the loss's relative error."""
    import torch

    P, m = rows.shape
    n = m - 1
    worst, bad = -math.inf, 0
    chunk = 1 << 24
    for lo in range(0, n, chunk):
        r = rows[:, lo:min(n, lo + chunk)].double()
        mean, absmean = r.mean(0), r.abs().mean(0)
        err = (g[lo:lo + r.shape[1]].double() - mean).abs()
        excess = err - P * 2.0 ** -24 * absmean
        worst = max(worst, float(excess.max()))
        bad += int((excess > 0).sum())
    want = float(rows[:, n].double().mean())
    loss_err = abs(float(loss) - want) / abs(want)
    return dict(label=label, worst_excess=worst, violations=bad,
                loss_err=loss_err, ok=bad == 0 and loss_err <= 1e-6)


def dp_part(model, params, batch: dict, on_card: bool) -> dict:
    """``make_dp_train_step`` on ``DP_LANES`` data-parallel lanes stacked on
    the card, one sequence a lane, under each of ``DP_METHODS`` (``auto``
    under ``LASSEN``), each one step from the same state.  The explicit
    variants' synced gradient (the optimizer's) and loss held to the lanes'
    rows by :func:`sync_check`, their relative norm gap to ``"jit"``'s
    gradient printed; K7 per lane-step as :func:`check_k7_per_step`; a
    planted fault (the plan's first round dropped) refused by the same
    check; ms a step and the peak memory."""
    import torch

    from repro_torch.core.costmodel import LASSEN
    from repro_torch.core.dense import dense_round_runner
    from repro_torch.train import trainer
    from repro_torch.train.optimizer import init_opt_state

    def loss_fn(p, b):
        return model.loss(p, b)[0]

    seen: dict = {}
    real_sync, real_adamw = trainer.make_grad_sync, trainer.adamw_update

    def recording_sync(*args, **kw):
        sync, plan, sel = real_sync(*args, **kw)
        seen["plan"] = plan

        def rec(flat):
            seen["rows"] = flat
            return sync(flat)

        return rec, plan, sel

    def recording_adamw(cfg, p, g, st):
        seen["grads"] = flat_grad(g)
        return real_adamw(cfg, p, g, st)

    out: dict = {"variants": {}}
    g_jit = None
    start = k7_counts()
    trainer.make_grad_sync, trainer.adamw_update = (recording_sync,
                                                    recording_adamw)
    try:
        for method in DP_METHODS:
            step, sel = trainer.make_dp_train_step(
                loss_fn, params, trainer.TrainerConfig(grad_sync=method),
                {"dp": DP_LANES}, "dp", machine=LASSEN)
            state = trainer.TrainState(params, init_opt_state(params), None)
            free_card(on_card)
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            before = k7_counts()
            card_sync(on_card)
            t0 = time.perf_counter()
            new, metrics = step(state, batch)
            loss = float(metrics["loss"])
            card_sync(on_card)
            secs = time.perf_counter() - t0
            lanes = 1 if method == "jit" else DP_LANES
            per = k7_since(before, lanes)
            check_k7_per_step(per, model.cfg.n_layers,
                              f"DP {method} lane-step" if lanes > 1
                              else "DP jit step", on_card)
            peak = (torch.cuda.max_memory_allocated() / 1e9 if on_card
                    else None)
            rec = dict(ms=secs * 1e3, loss=loss, peak_gb=peak,
                       chosen=None if sel is None else sel.chosen,
                       modeled_s=None if sel is None
                       else sel.modeled_times, k7=per)
            g = seen.pop("grads")
            if method == "jit":
                g_jit = g
                rec["loss_err"] = 0.0
            else:
                rows = seen.pop("rows")
                chk = sync_check(rows, g, loss, method)
                rec.update(chk, norm_gap=float(
                    torch.linalg.vector_norm(g - g_jit)
                    / torch.linalg.vector_norm(g_jit)),
                    jit_loss_err=abs(loss - out["variants"]["jit"]["loss"])
                    / abs(out["variants"]["jit"]["loss"]))
                if not chk["ok"] or rec["jit_loss_err"] > 1e-6:
                    fail(f"train DP {method}: synced gradient {chk['violations']}"
                         f" elements past P 2^-24 mean_p |g_p| of the lanes' "
                         f"float64 mean (worst excess {chk['worst_excess']:.3e}),"
                         f" loss {chk['loss_err']:.3e} off their mean and "
                         f"{rec['jit_loss_err']:.3e} off jit's (tolerance 1e-6)")
                if method == DP_METHODS[-1]:
                    # the planted fault: the plan's first round dropped
                    plan = seen["plan"]
                    broken = dataclasses.replace(plan, rounds=plan.rounds[1:])
                    run = dense_round_runner(broken, rows.device)
                    n_seg, cmax = len(plan.counts), plan.cmax
                    P, m = rows.shape
                    buf = rows.new_zeros((P, n_seg + 1, cmax))
                    buf.view(P, -1)[:, :m] = rows
                    faulty = run.padded(buf).view(P, -1)[0, :m] / P
                    del buf
                    bad = sync_check(rows, faulty, float(faulty[-1]),
                                     "planted")
                    del faulty
                    if bad["ok"]:
                        fail("train DP: the sync with its plan's first round "
                             "dropped passes the check")
                    rec["planted"] = bad
                    log(f"train DP refuses a planted fault, the plan's first "
                        f"round dropped: {bad['violations']} elements past "
                        f"the bound (worst excess {bad['worst_excess']:.3e}), "
                        f"loss {bad['loss_err']:.3e} off")
                del rows
            del g, new, state, step
            out["variants"][method] = rec
            log(f"train DP {method}"
                + (f" (chose {rec['chosen']} under LASSEN)" if sel else "")
                + f": one step of {DP_LANES} x {batch['tokens'].shape[1]} "
                f"tokens in {rec['ms']:.1f} ms, loss {loss:.6f}"
                + (f"; synced gradient within P 2^-24 mean_p |g_p| of the "
                   f"lanes' float64 mean (worst excess "
                   f"{rec['worst_excess']:.3e}), loss {rec['loss_err']:.3e} "
                   f"off it and {rec['jit_loss_err']:.3e} off jit's; "
                   f"relative norm gap to jit's gradient {rec['norm_gap']:.3e}"
                   if method != "jit" else "")
                + f"; K7 a {'lane-' if method != 'jit' else ''}step {per}; "
                f"peak " + (f"{peak:.2f} GB" if peak is not None
                            else "not measured"))
    finally:
        trainer.make_grad_sync, trainer.adamw_update = real_sync, real_adamw
    del g_jit
    out["k7"] = k7_since(start)
    return out


def grad_sync_problem_check(device: str) -> dict:
    """``repro``'s ``check_grad_sync`` problem (a 16 x 4 linear model in
    float64, 32 rows over 8 lanes) with the port's functions on
    ``device``: every explicit variant within 1e-12 of ``"jit"`` in loss
    and updated parameters."""
    import numpy as np
    import torch

    from repro_torch.core.costmodel import LASSEN
    from repro_torch.train import trainer
    from repro_torch.train.optimizer import init_opt_state

    rng = np.random.default_rng(1)
    params = {"w": torch.tensor(rng.normal(size=(16, 4)), device=device),
              "b": torch.tensor(rng.normal(size=(4,)), device=device)}
    batch = {"x": torch.tensor(rng.normal(size=(32, 16)), device=device),
             "y": torch.tensor(rng.normal(size=(32, 4)), device=device)}

    def loss_fn(p, b):
        return torch.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)

    outs = {}
    for method in DP_METHODS:
        step, _ = trainer.make_dp_train_step(
            loss_fn, params, trainer.TrainerConfig(grad_sync=method),
            {"dp": DP_LANES}, "dp", machine=LASSEN)
        st, m = step(trainer.TrainState(params, init_opt_state(params),
                                        None), batch)
        outs[method] = (st.params, float(m["loss"]))
    ref_p, ref_l = outs["jit"]
    worst = 0.0
    for method in DP_METHODS[1:]:
        p, loss = outs[method]
        worst = max(worst, abs(loss - ref_l), *(
            float(torch.max(torch.abs(p[k] - ref_p[k]))) for k in ref_p))
    if not worst < 1e-12:
        fail(f"train DP check_grad_sync problem: a variant {worst:.3e} off "
             "jit (tolerance 1e-12)")
    log(f"train DP check_grad_sync problem (16 x 4, float64): ring, hier, "
        f"auto within {worst:.3e} of jit (tolerance 1e-12)")
    return dict(worst=worst)


def train_run(device: str = "cuda", reduced_config: bool = False,
              out_dir: Optional[Path] = None) -> dict:
    """The train phase.  Its main path first, with every launch count set to
    0 just before it and read just after: the launcher
    (:func:`launcher_part`) and the explicit DP grad sync
    (:func:`dp_part`).  Then, off the main path, the lane-step oracle and
    K7's calls (:func:`oracle_part`), a lane-step with labels -1 and V
    (:func:`label_check`), K7's backward and float32 forward at calls the
    path does not make (:func:`bwd_edge_checks`, :func:`fwd_edge_checks`)
    and ``check_grad_sync``'s problem (:func:`grad_sync_problem_check`).  Returns their records, K7's forward
    and backward records, and the main path's calls and CUDA launches."""
    import torch

    from repro_torch.kernels import CUDA_LAUNCHES, LAUNCHES, reset_launches
    from repro_torch.models import Model
    from repro_torch.train import DataConfig, TokenStream

    on_card = device == "cuda"
    sizes = train_sizes(on_card)
    cfg = train_config(reduced_config, sizes)
    out_dir = out_dir or ROOT / "chiprun_out" / "train_ckpt"
    t0 = time.perf_counter()
    reset_launches()
    launcher = launcher_part(cfg, device, on_card, sizes, out_dir,
                             reduced_config)
    free_card(on_card)
    model = Model(cfg, device=device)
    params = model.init_params(seed=TRAIN_SEED)
    data = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=sizes["lane_seq"],
                                  global_batch=DP_LANES, seed=TRAIN_SEED))
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in data.global_batch_at(0).items()}
    dp = dp_part(model, params, batch, on_card)
    launches = {k: LAUNCHES[k] for k in launcher["k7"]}
    cuda = {k: CUDA_LAUNCHES[k] for k in launcher["k7"]}
    free_card(on_card)
    oracle = oracle_part(model, params,
                         {k: v[:1] for k, v in batch.items()}, on_card,
                         sizes["batch"])
    labels = label_check(model, params, {k: v[:1] for k, v in batch.items()},
                         on_card)
    oracle["kernels"][BWD]["edge_max_abs_err"] = bwd_edge_checks(
        device, torch.Generator().manual_seed(TRAIN_SEED))
    oracle["kernels"]["flash_attention_bh"]["f32_edge_max_err"] = \
        fwd_edge_checks(device, torch.Generator().manual_seed(TRAIN_SEED))
    del params, model, batch
    free_card(on_card)
    problem = grad_sync_problem_check(device)
    seconds = time.perf_counter() - t0
    log(f"train phase: K7 calls on the main path (the launcher's runs and "
        f"the DP steps) {launches}, CUDA launches {cuda}; {seconds:.1f} s")
    return dict(launcher=launcher, oracle=oracle, dp=dp, problem=problem,
                labels=labels,
                kernels=oracle["kernels"], launches=launches,
                cuda_launches=cuda, seconds=seconds)


# ------------------------------------------------------------ adaptive phase
ADAPT_REFIT_EVERY = 8          # decode steps between online refits
ADAPT_WARM_STEPS = 9           # decode steps before the steady window: the
#                                first refit (step 8) binds its probe
ADAPT_STEADY_STEPS = 12        # steady decode steps: no event, no new miss
ADAPT_DRIFT_MAX_STEPS = 12     # decode steps allowed for the drift to fire
ADAPT_AFTER_STEPS = 4          # decode steps after the swap, each held to
#                                the plain K5-K7
ADAPT_DRIFT_MIN = 0.3          # the engine's drift threshold


def adaptive_sizes(on_card: bool) -> dict:
    """Four requests on the four slots, long enough that no slot finishes
    in the phase; off the card, the CPU rehearsal's tiny sizes."""
    if on_card:
        return dict(slots=4, max_len=512, prompts=(64, 64, 64, 64),
                    new=(48, 48, 48, 48))
    return dict(slots=4, max_len=64, prompts=(6, 6, 6, 6),
                new=(48, 48, 48, 48))


def oracle_decode(fn, model, engine, got: list, want: list, launched: dict):
    """``fn`` (an engine decode function) wrapped so that each step is also
    replayed through the plain K5-K7 on a copy of the caches it is given,
    under the engine's pinned plan and the step's own routing decisions;
    the logits of both land in ``got`` / ``want`` and the launches of the
    kernel run add into ``launched``."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import serving

    def run(p, i, c, n):
        saved = tuple({k: v.clone() for k, v in layer.items()} for layer in c)
        decisions: list = []
        before = dict(LAUNCHES)
        with routing(decisions, replay=False):
            out = fn(p, i, c, n)
        for k in LAUNCHES:
            launched[k] = launched.get(k, 0) + LAUNCHES[k] - before[k]
        with plain_kernels(), routing(decisions, replay=True):
            ref = serving.decode_step(model, p, i, saved, n,
                                      moe_plan=engine.moe_plan,
                                      return_moe_stats=True)
        got.append(out[0].float().cpu())
        want.append(ref[0].float().cpu())
        return out

    return run


def adaptive_phase(model, params, on_card: bool) -> dict:
    """The adaptive engine on the served model's weights: ``ServeEngine(
    adaptive=True, observe=True, refit_every=8)`` under ``auto``.  Steady
    decode must re-plan nothing (no event, no new plan-cache or executor
    miss); with every MoE layer's router zeroed (ties go to the lower
    expert ids, so every token lands on the experts 0..top_k-1) exactly one
    ``ReplanEvent`` must fire, with a drift above 0.3 and a transport mode,
    and none after; every decode step after the swap is held to its replay
    through the plain K5-K7 within ``LOGIT_TOL``, and K5-K7 must launch
    there; at least one converged ``RefitEvent`` must set the planner's
    params; ``engine.verify()`` passes before and after the re-plan and
    refuses a planted broken plan.  The router is restored after."""
    import torch

    from repro_torch.obs import default_obs
    from repro_torch.serve import ServeEngine
    from repro_torch.verify import VerifyError

    sizes = adaptive_sizes(on_card)
    obs = default_obs()
    t_phase = time.perf_counter()
    eng = ServeEngine(model, params, batch_slots=sizes["slots"],
                      max_len=sizes["max_len"], adaptive=True, observe=True,
                      refit_every=ADAPT_REFIT_EVERY)
    before_verify = eng.verify()
    for r in serve_requests(model.cfg.vocab, sizes):
        eng.submit(r)
    for _ in range(ADAPT_WARM_STEPS):
        eng.step()
    card_sync(on_card)
    cache = eng.plan_cache
    m0, e0 = cache.misses, cache.exec_misses
    t0 = time.perf_counter()
    for _ in range(ADAPT_STEADY_STEPS):
        eng.step()
    card_sync(on_card)
    steady_ms = (time.perf_counter() - t0) * 1e3 / ADAPT_STEADY_STEPS
    new_misses = (cache.misses - m0, cache.exec_misses - e0)
    log(f"adaptive: {ADAPT_STEADY_STEPS} steady decode steps "
        f"({steady_ms:.3f} ms a step, refits included), decode plan "
        f"{eng.moe_plan.mode}; replan events {len(eng.replan_events)}, new "
        f"plan-cache / executor misses {new_misses}; verify "
        f"{before_verify}")
    if eng.replan_events or new_misses != (0, 0):
        fail(f"adaptive: steady decode re-planned ({eng.replan_events}, "
             f"new misses {new_misses})")

    router = params["blocks"]["moe"]["router"]
    saved_router = router.clone()
    router.zero_()
    try:
        old_mode = eng.moe_plan.mode
        steps = 0
        while not eng.replan_events and steps < ADAPT_DRIFT_MAX_STEPS:
            eng.step()
            steps += 1
        events = list(eng.replan_events)
        if len(events) != 1:
            fail(f"adaptive: {len(events)} replan events in {steps} steps "
                 "after the router was zeroed, expected 1")
        ev = events[0]
        log(f"adaptive: router zeroed; {ev} after {steps} steps "
            f"(mode {old_mode} -> {eng.moe_plan.mode})")
        if not (ev.drift > ADAPT_DRIFT_MIN
                and ev.new_mode in ("a2a", "hier", "hier_dedup")
                and eng.moe_plan is eng.planner.plan):
            fail(f"adaptive: event {ev} (drift must exceed "
                 f"{ADAPT_DRIFT_MIN}, mode a transport)")
        got, want, launched = [], [], {}
        eng._decode = oracle_decode(eng._decode, model, eng, got, want,
                                    launched)
        for _ in range(ADAPT_AFTER_STEPS):
            eng.step()
        card_sync(on_card)
        if len(eng.replan_events) != 1 or len(got) != ADAPT_AFTER_STEPS:
            fail(f"adaptive: {len(eng.replan_events)} events after "
                 f"{ADAPT_AFTER_STEPS} more steps ({len(got)} checked)")
        res = compare_logits(got, want)
        log(f"adaptive: {ADAPT_AFTER_STEPS} decode steps after the swap "
            f"against the plain K5-K7 under the new plan: max |logit diff| "
            f"/ max |logit| {res['rel_err']:.3e} (tolerance {LOGIT_TOL}), "
            f"greedy tokens differ on {res['differ']} of {res['sure']} rows "
            f"with a clear margin; launches {launched}")
        if not res["rel_err"] <= LOGIT_TOL or res["differ"]:
            fail(f"adaptive: logits after the swap off the plain replay by "
                 f"{res['rel_err']:.3e}")
        missing = [k for k in SERVE_SOURCES if launched.get(k, 0) <= 0]
        if on_card and missing:
            fail(f"adaptive: kernels not launched after the swap: {missing}")
        after_verify = eng.verify()
        broken = dataclasses.replace(eng.moe_plan,
                                     e_per_dev=eng.moe_plan.e_per_dev + 1)
        live = eng.moe_plan
        eng.moe_plan = broken
        try:
            eng.verify()
            fail("adaptive: engine.verify() accepted a broken MoEPlan")
        except VerifyError as e:
            log(f"adaptive: engine.verify() refuses a planted fault, "
                f"e_per_dev + 1: {e}")
        finally:
            eng.moe_plan = live
    finally:
        router.copy_(saved_router)
        obs.disable()
        obs.attach_tracer(None)
    refits = list(eng.refit_events)
    if not refits or eng.planner.params is not eng.machine_params:
        fail(f"adaptive: refits {refits}; planner params "
             f"{getattr(eng.planner.params, 'name', None)} are not the "
             "fitted set")
    fitted = eng.machine_params
    log(f"adaptive: {len(refits)} converged refits ({refits[-1]}); fitted "
        f"params: " + ", ".join(
            f"{f.name}={getattr(fitted, f.name):.4g}"
            for f in dataclasses.fields(fitted)
            if isinstance(getattr(fitted, f.name), float)))
    log(f"adaptive: verify before {before_verify}, after {after_verify}; "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    return dict(steady_ms=steady_ms, event=str(ev), drift=ev.drift,
                old_mode=ev.old_mode, new_mode=ev.new_mode,
                oracle_rel_err=res["rel_err"], launched=launched,
                refits=[str(r) for r in refits], fitted=dataclasses.asdict(
                    fitted), seconds=time.perf_counter() - t_phase)


ELASTIC_SERVE_SHRINK = 4       # EP lanes left after the heartbeat
ELASTIC_SERVE_GEOMETRY = (("data", "model"), (1, 4))
ELASTIC_SERVE_STEPS = 4        # decode steps before and after the resize
ELASTIC_SERVE_BACK_STEPS = 2   # decode steps after the grow-back


def elastic_serve_sizes(on_card: bool) -> dict:
    """The serve phase's sizes, whose requests all outlast the phase's
    decode steps; off the card, tiny ones that do too."""
    if on_card:
        return serve_sizes(on_card)
    return dict(slots=4, max_len=64, prompts=(5, 12, 9, 7, 3, 6),
                new=(12,) * 6)


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def elastic_serve_phase(model, params, on_card: bool) -> dict:
    """Elastic serving on the served weights: ``ServeEngine(elastic=True)``
    on the serve mesh (2 pods x 4 lanes), 4 slots, the serve phase's
    requests, ``cap_factor`` :func:`no_drop_cap` (the lane count changes
    which pairs overflow an expert, so only where none can does it change
    no function; ``AMPLE_CAP``, the reference elastic program's 8, lets
    8 lanes drop the left pads of the shortest prompt and 4 not);
    4 decode steps, ``resize(4)`` (the heartbeat: the geometry must be
    (data 1, model 4) and no weight tensor may move), 4 more.

    The lane count: the engine's first prefill (the first requests'
    prompts) runs again on the 8 lanes with its routing and its MoE layers'
    calls recorded, then after the resize on the 4.  Held: no pair dropped;
    each MoE layer run on the 4 lanes from the 8 lanes' input of that
    layer, with their routing laid onto the 4 (:func:`relaid`), within
    ``SERVE_TOL`` (bf16) of the 8 lanes' output; the whole prefill's logits
    within ``LOGIT_TOL``, greedy tokens equal on every row whose top-2
    margin exceeds it.  Planted: the layer check under K6 reading every
    lane's rows from lane 0; at ``AMPLE_CAP`` the 8 lanes must drop pairs
    that the 4 keep.

    The resize against a cold 4-lane engine from the prompts
    (:func:`against_cold`), call by call up to the first split: greedy
    tokens equal on every row with a clear margin; the logits are printed
    (a re-prefill and a decode step round apart, and 27 layers of random
    bf16 weights grow that past ``LOGIT_TOL``), and held in float32 at full
    width, cut depth (:func:`elastic_float32`): tokens identical, logits
    within ``F32_LOGIT_TOL``.

    The carry-over: a cold 4-lane engine on the same weight tensors,
    admitted with the requests as they stood at the resize (prompt +
    generated), must give identical greedy tokens and every call's logits
    within ``LOGIT_TOL``; it repeats the resize's re-prefill, so it holds
    what the resize carries over, not the lane count.  Planted fault: a
    resume with one slot's last generated token dropped from its history
    must fail it.  Every engine call after the resize is replayed through
    the plain K5-K7 within ``LOGIT_TOL`` (routing replayed); K5-K7 calls
    per decode step on 4 lanes are printed beside 8 lanes'; ``resize(8)``
    back must be warm, then 2 decode steps."""
    import copy

    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import Mesh, Model, serving
    from repro_torch.models.moe import moe_layer
    from repro_torch.serve import ServeEngine

    sizes = elastic_serve_sizes(on_card)
    cfg = model.cfg
    t_phase = time.perf_counter()
    start = dict(LAUNCHES)
    eng = ServeEngine(model, params, batch_slots=sizes["slots"],
                      max_len=sizes["max_len"], elastic=True)
    calls = recording_engine(eng, on_card)
    for r in serve_requests(cfg.vocab, sizes):
        eng.submit(r)
    for _ in range(ELASTIC_SERVE_STEPS):
        eng.step()
    n8, mode8 = len(calls), eng.moe_plan.mode

    # the first prefill again on the 8 lanes, its routing and its MoE
    # layers' calls recorded
    first = calls[0]
    if first["kind"] != "prefill":
        fail(f"elastic serve: the first engine call is a {first['kind']}")
    B, S = first["tokens"].shape
    mesh8 = eng.model.mesh

    def first_prefill(layers: list, route):
        with route, moe_layer_calls(layers):
            logits, _ = serving.prefill(
                eng.model, eng.params,
                {"tokens": first["tokens"].to(eng.model.device)},
                max_len=eng.max_len, moe_plan=eng.moe_prefill_plan)
            card_sync(on_card)
        return logits.float().cpu()

    by8, layers8 = [], []
    lanes8 = first_prefill(layers8, routing(by8, replay=False))

    snapshot = copy.deepcopy(eng.slots)
    decisions: list = []
    with routing(decisions, replay=False):
        shrink = eng.resize(ELASTIC_SERVE_SHRINK, reason="heartbeat")
        for _ in range(ELASTIC_SERVE_STEPS):
            eng.step()
    card_sync(on_card)
    geometry = (tuple(eng.model.mesh.axis_names), tuple(eng.model.mesh.shape))
    moved = [i for i, (a, b) in enumerate(zip(leaves(params),
                                              leaves(eng.params)))
             if a.data_ptr() != b.data_ptr()]
    log(f"elastic serve: {shrink}; geometry {geometry}, e_phys "
        f"{model.e_phys} -> {eng.model.e_phys}, weight tensors moved "
        f"{len(moved)}; decode plan {mode8} -> {eng.moe_plan.mode}")
    if geometry != ELASTIC_SERVE_GEOMETRY or moved:
        fail(f"elastic serve: geometry {geometry}, moved leaves {moved}")
    if not (shrink.old_n == 8 and shrink.new_n == ELASTIC_SERVE_SHRINK):
        fail(f"elastic serve: {shrink}")
    launches = {k: LAUNCHES[k] - start[k] for k in SERVE_SOURCES}
    toks = [list(s.generated) for s in eng.slots]
    after = calls[n8:]

    # the lane count: the first prefill on the 4 lanes, then each MoE
    # layer on the 4 lanes from the 8 lanes' input of that layer, with its
    # routing
    relay = relaid(mesh8, eng.model.mesh, B, S)
    layers4: list = []
    lanes4 = first_prefill(layers4, contextlib.nullcontext())
    layer_err, layer_flips = [], []
    dropped = max(c[3] for c in layers8 + layers4)
    for i, ((a8, _, y8, _), (a4, kw4, _, _)) in enumerate(
            zip(layers8, layers4)):
        with routing([by8[i]], replay=True, relay=relay) as fl:
            y4 = moe_layer(a8[0], *a4[1:], **kw4)[0]
        layer_err.append(rel_err(y4.float(), y8.float()))
        layer_flips.append(fl["flipped"])
    card_sync(on_card)
    worst = max(range(len(layer_err)), key=layer_err.__getitem__)
    own = compare_logits([lanes4], [lanes8])
    top2 = lanes8.topk(2, dim=-1).values
    gaps = [round(float(g), 5) for g in top2[:, 0] - top2[:, 1]]
    log(f"elastic serve: the first prefill ({B} x {S} tokens) on 4 lanes "
        f"against 8: the largest share of a MoE layer's pairs dropped "
        f"{dropped}; each of the {len(layer_err)} MoE layers from the 8 "
        f"lanes' input, their routing relaid: max |diff| / max |output| at "
        f"most {layer_err[worst]:.3e} (layer {worst}; tolerance "
        f"{SERVE_TOL['bfloat16']}), token routings of their own that differ "
        f"{layer_flips} of {B * S}")
    log(f"elastic serve: the whole first prefill on 4 lanes against 8: max "
        f"|logit diff| / max |logit| {own['rel_err']:.3e} (tolerance "
        f"{LOGIT_TOL}), greedy tokens differ on "
        f"{int((lanes4.argmax(-1) != lanes8.argmax(-1)).sum())} of {B} rows, "
        f"on {own['differ']} of the {own['sure']} with a top-2 margin above "
        f"the tolerance (the 8 lanes' top-2 gaps {gaps}, max |logit| "
        f"{float(lanes8.abs().max()):.5f})")
    if dropped:
        fail(f"elastic serve: the first prefill drops pairs ({dropped})")
    if (len(layer_err) != len(layers4) or not layer_err
            or not layer_err[worst] <= SERVE_TOL["bfloat16"]):
        fail(f"elastic serve: a MoE layer on 4 lanes is "
             f"{layer_err[worst]:.3e} off the 8 lanes' (layer {worst} of "
             f"{len(layer_err)})")
    if not own["rel_err"] <= LOGIT_TOL or own["differ"]:
        fail(f"elastic serve: the first prefill on 4 lanes is "
             f"{own['rel_err']:.3e} off the 8 lanes', greedy tokens differ on "
             f"{own['differ']} rows with a clear margin")
    # planted: that layer with K6 reading every lane's rows from lane 0
    (a8, _, y8, _), (a4, kw4, _, _) = layers8[worst], layers4[worst]
    with (planted_faults()["K6 reads every lane's rows from lane 0"],
          routing([by8[worst]], replay=True, relay=relay)):
        lane_fault = rel_err(moe_layer(a8[0], *a4[1:], **kw4)[0].float(),
                             y8.float())
    if lane_fault <= SERVE_TOL["bfloat16"]:
        fail("elastic serve: the layer check misses K6 reading every lane's "
             "rows from lane 0")
    log(f"elastic serve: the layer check refuses a planted fault, K6 reads "
        f"every lane's rows from lane 0: {lane_fault:.3e} off")
    del layers8, layers4

    # planted: the reference program's AMPLE_CAP, where an expert can
    # overflow; the 8 lanes must drop pairs that the 4 lanes keep
    if AMPLE_CAP < no_drop_cap(cfg):
        ample = {}
        for n, mesh in ((8, mesh8), (4, eng.model.mesh)):
            m = Model(cfg, mesh=mesh, moe_mode=model.moe_mode,
                      ep_over_pods=model.ep_over_pods,
                      moe_cap_factor=AMPLE_CAP,
                      machine_params=model.machine_params,
                      device=model.device)
            layers: list = []
            plan = serving.moe_plan_for_model(m, eng.B * eng.max_len)
            with moe_layer_calls(layers):
                logits, _ = serving.prefill(
                    m, params, {"tokens": first["tokens"].to(m.device)},
                    max_len=eng.max_len, moe_plan=plan)
            ample[n] = (logits.float().cpu(), max(c[3] for c in layers))
            del layers
        card_sync(on_card)
        at_cap = compare_logits([ample[4][0]], [ample[8][0]])
        log(f"elastic serve: the first prefill at cap_factor {AMPLE_CAP} "
            f"(below {no_drop_cap(cfg):.4f}): dropped pairs on 8 lanes "
            f"{ample[8][1]}, on 4 {ample[4][1]} (largest share of a MoE "
            f"layer); 4 lanes against 8, max |logit diff| / max |logit| "
            f"{at_cap['rel_err']:.3e}")
        if not ample[8][1] > ample[4][1]:
            fail(f"elastic serve: at cap_factor {AMPLE_CAP} the 8 lanes drop "
                 f"no more than the 4 ({ample[8][1]}, {ample[4][1]})")
        del ample

    cold_model = Model(cfg, mesh=Mesh(*ELASTIC_SERVE_GEOMETRY),
                       moe_mode=model.moe_mode,
                       ep_over_pods=model.ep_over_pods,
                       moe_cap_factor=model.moe_cap_factor,
                       machine_params=model.machine_params,
                       device=model.device)

    def cold_engine(requests, steps: int):
        e = ServeEngine(cold_model, params, batch_slots=sizes["slots"],
                        max_len=sizes["max_len"])
        rec = recording_engine(e, on_card)
        for r in requests:
            e.submit(r)
        for _ in range(steps):
            e.step()
        card_sync(on_card)
        return [list(x.generated) for x in e.slots], rec

    # the resize against a cold 4-lane engine run from the prompts
    cold_toks, cold_calls = cold_engine(serve_requests(cfg.vocab, sizes),
                                        2 * ELASTIC_SERVE_STEPS)
    cold = against_cold(calls[:ELASTIC_SERVE_STEPS] + after, cold_calls)
    log(f"elastic serve vs a cold 4-lane engine from the prompts "
        f"({2 * ELASTIC_SERVE_STEPS} steps each): greedy tokens equal "
        f"{toks == cold_toks}; the calls giving tokens 1-{len(cold['steps'])},"
        f" max |logit diff| / max |logit| "
        f"{[f'{x:.2e}' for x in cold['steps']]} (tolerance {LOGIT_TOL}, held "
        f"in float32 below), greedy tokens differ on {cold['differ']} of "
        f"{cold['sure']} rows with a top-2 margin above it; first split "
        f"{cold['split']} (the cold engine's top-2 gap and max |logit| there)")
    if cold["differ"]:
        fail(f"elastic serve: tokens {toks} vs a cold engine's {cold_toks}: "
             f"greedy tokens differ on {cold['differ']} rows with a clear "
             "margin")
    del cold_calls

    # the carry-over: a cold 4-lane engine admitted with the histories
    same_toks, same_calls = cold_engine(copy.deepcopy(snapshot),
                                        ELASTIC_SERVE_STEPS)
    cmp = compare_logits([c["logits"] for c in after],
                         [c["logits"] for c in same_calls])
    log(f"elastic serve vs a cold 4-lane engine admitted with the histories "
        f"at the resize ({len(after)} calls each): greedy tokens equal "
        f"{toks == same_toks}; max |logit diff| / max |logit| "
        f"{cmp['rel_err']:.3e} (tolerance {LOGIT_TOL})")
    if (toks != same_toks or len(after) != len(same_calls)
            or not cmp["rel_err"] <= LOGIT_TOL):
        fail(f"elastic serve: tokens {toks} vs {same_toks}, logits "
             f"{cmp['rel_err']:.3e} off")

    res = replay_plain(eng.model, eng.params, eng, after, decisions, on_card)
    per8, per4 = serve_summary(calls[:n8]), serve_summary(after)
    log(f"elastic serve: {len(after)} engine calls after the resize "
        f"through the plain K5-K7, routing replayed: max |logit diff| / "
        f"max |logit| {res['oracle_rel_err']:.3e} (tolerance {LOGIT_TOL}); "
        f"K5-K7 calls per decode step on 4 lanes "
        f"{per4['launches_per_decode']} beside 8 lanes' "
        f"{per8['launches_per_decode']}; ms per decode step "
        f"{per4['decode_ms']:.3f} beside {per8['decode_ms']:.3f}")

    grow = eng.resize(8, reason="requested")
    for _ in range(ELASTIC_SERVE_BACK_STEPS):
        eng.step()
    card_sync(on_card)
    log(f"elastic serve: grow-back {grow}; {ELASTIC_SERVE_BACK_STEPS} "
        "decode steps after it")
    if not (grow.warm and grow.plan_misses == 0):
        fail(f"elastic serve: the grow-back is not warm: {grow}")
    missing = [k for k, n in launches.items() if n <= 0]
    if on_card and missing:
        fail(f"elastic serve: kernels not launched: {missing}")

    # planted: the resume with slot 0's last generated token dropped
    fault = ServeEngine(model, params, batch_slots=sizes["slots"],
                        max_len=sizes["max_len"], elastic=True)
    fault.slots = copy.deepcopy(snapshot)
    fault.slots[0].generated.pop()
    fault_calls = recording_engine(fault, on_card)
    fault.resize(ELASTIC_SERVE_SHRINK, reason="heartbeat")
    for _ in range(ELASTIC_SERVE_STEPS):
        fault.step()
    card_sync(on_card)
    bad = compare_logits([c["logits"] for c in fault_calls],
                         [c["logits"] for c in same_calls])
    bad_toks = [list(s.generated[-ELASTIC_SERVE_STEPS:])
                for s in fault.slots]
    want_toks = [t[-ELASTIC_SERVE_STEPS:] for t in same_toks]
    if bad["rel_err"] <= LOGIT_TOL and bad_toks == want_toks:
        fail("elastic serve: a resume missing a generated token passes")
    log(f"elastic serve refuses a planted fault, slot 0's last generated "
        f"token dropped before the resume: max |logit diff| / max |logit| "
        f"{bad['rel_err']:.3e}, tokens after the resume equal "
        f"{bad_toks == want_toks}")
    del fault, fault_calls, same_calls
    f32 = elastic_float32(model, on_card)
    out = dict(f32=f32, shrink=dataclasses.asdict(shrink),
               grow=dataclasses.asdict(grow), geometry=geometry,
               layer_err=layer_err, layer_flips=layer_flips,
               lane_fault=lane_fault, dropped=dropped,
               cold_steps=cold["steps"], cold_split=cold["split"],
               cold_tokens_equal=toks == cold_toks,
               lanes_rel_err=own["rel_err"], lanes_differ=own["differ"],
               top2_gaps=gaps,
               same_rel_err=cmp["rel_err"],
               oracle_rel_err=res["oracle_rel_err"], launches=launches,
               per_decode4=per4["launches_per_decode"],
               per_decode8=per8["launches_per_decode"],
               decode_ms4=per4["decode_ms"], decode_ms8=per8["decode_ms"],
               planted=bad["rel_err"], seconds=time.perf_counter() - t_phase)
    log(f"elastic serve: launches {launches}; phase {out['seconds']:.1f} s")
    return out


def against_cold(mine: list, cold: list, tol: float = LOGIT_TOL) -> dict:
    """An elastic engine's calls that gave tokens 1, 2, ... (``mine``: the
    prefill and decode steps before the resize, then the re-prefill and
    the steps after it) against a cold engine's (its prefill and decode
    steps), call by call while every history agrees: up to and with the
    first call whose greedy token differs on a row.  Returns each call's
    max |logit diff| / max |logit| (``steps``), the rows with a top-2
    margin above ``tol`` (``sure``) and those of them whose greedy tokens
    differ (``differ``), and the first split (slot, token, the cold
    engine's top-2 gap and max |logit| there)."""
    import torch

    steps, sure, differ, split = [], 0, 0, None
    for t, (e, c) in enumerate(zip(mine, cold)):
        res = compare_logits([e["logits"]], [c["logits"]], tol)
        steps.append(res["rel_err"])
        sure, differ = sure + res["sure"], differ + res["differ"]
        rows = torch.nonzero(e["logits"].argmax(-1) != c["logits"].argmax(-1))
        if len(rows):
            i = int(rows[0, 0])
            top2 = c["logits"][i].topk(2).values
            split = dict(slot=i, token=t, gap=float(top2[0] - top2[1]),
                         max_logit=float(c["logits"][i].abs().max()))
            break
    return dict(steps=steps, sure=sure, differ=differ, split=split)


ELASTIC_F32_LAYERS = 4          # 1 dense + 3 MoE layers: 8.6 GB in float32
# whole-model logits in float32: LOGIT_TOL is 4 bf16 kernel tolerances
# (SERVE_TOL), so 4 float32 ones
F32_LOGIT_TOL = 4 * SERVE_TOL["float32"]


def elastic_float32(model, on_card: bool) -> dict:
    """The reference's resize contract (``check_elastic.py``'s decode
    shrink) at full width in float32, depth cut to ``ELASTIC_F32_LAYERS``
    (the reference holds it in float64: bf16 rounds a re-prefill and a
    decode step apart by more than ``LOGIT_TOL`` through 27 layers of
    random weights).  An 8-lane elastic engine of ``model``'s settings, 4
    steps, ``resize(4)``, 4 more, against a cold 4-lane engine of 8 steps
    from the same prompts: greedy tokens identical and every call's logits
    within ``F32_LOGIT_TOL``."""
    import torch

    from repro_torch.models import Mesh, Model
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(model.cfg, dtype=torch.float32, n_layers=min(
        ELASTIC_F32_LAYERS, model.cfg.n_layers))
    sizes = elastic_serve_sizes(on_card)
    t0 = time.perf_counter()

    def engine(mesh, params=None, elastic=False):
        m = Model(cfg, mesh=mesh, moe_mode=model.moe_mode,
                  ep_over_pods=model.ep_over_pods,
                  moe_cap_factor=model.moe_cap_factor,
                  machine_params=model.machine_params, device=model.device)
        params = m.init_params(seed=SERVE_SEED) if params is None else params
        e = ServeEngine(m, params, batch_slots=sizes["slots"],
                        max_len=sizes["max_len"], elastic=elastic)
        for r in serve_requests(cfg.vocab, sizes):
            e.submit(r)
        return e, recording_engine(e, on_card)

    eng, calls = engine(model.mesh, elastic=True)
    for _ in range(ELASTIC_SERVE_STEPS):
        eng.step()
    n8 = len(calls)
    eng.resize(ELASTIC_SERVE_SHRINK, reason="heartbeat")
    for _ in range(ELASTIC_SERVE_STEPS):
        eng.step()
    cold, cold_calls = engine(Mesh(*ELASTIC_SERVE_GEOMETRY), eng.params)
    for _ in range(2 * ELASTIC_SERVE_STEPS):
        cold.step()
    card_sync(on_card)
    toks = [list(s.generated) for s in eng.slots]
    cold_toks = [list(s.generated) for s in cold.slots]
    res = against_cold(calls[:ELASTIC_SERVE_STEPS] + calls[n8:], cold_calls,
                       F32_LOGIT_TOL)
    worst = max(res["steps"])
    log(f"elastic serve in float32 ({cfg.n_layers} layers of full width): "
        f"vs a cold 4-lane engine from the prompts ({2 * ELASTIC_SERVE_STEPS}"
        f" steps each): greedy tokens equal {toks == cold_toks}; the calls "
        f"giving tokens 1-{len(res['steps'])}, max |logit diff| / max "
        f"|logit| {[f'{x:.2e}' for x in res['steps']]} (tolerance "
        f"{F32_LOGIT_TOL}); {time.perf_counter() - t0:.1f} s")
    if toks != cold_toks or not worst <= F32_LOGIT_TOL:
        fail(f"elastic serve in float32: tokens {toks} vs a cold engine's "
             f"{cold_toks}, logits {worst:.3e} off")
    del eng, cold, calls, cold_calls
    return dict(steps=res["steps"], tokens_equal=toks == cold_toks,
                layers=cfg.n_layers)


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
    adaptive = adaptive_phase(model_for("auto"), params, on_card)
    elastic = elastic_serve_phase(model_for("auto", no_drop_cap(cfg)), params,
                                  on_card)
    return dict(modes=modes, launches=launches, cuda_launches=cuda_launches,
                kernels=kernels, profile=prof, n_params=n_params,
                n_bytes=n_bytes, adaptive=adaptive, elastic=elastic)


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
            fa_cuda.BWD_LIBRARY, ssd_cuda.LIBRARY]
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
    phases = {"build": time.perf_counter() - t_start}

    def done(name: str) -> None:
        phases[name] = time.perf_counter() - t_start - sum(phases.values())
        log(f"{name} phase done at {time.perf_counter() - t_start:.1f} s "
            f"({phases[name]:.1f} s)")

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
    done("AMG")
    serve = serve_run("cuda")
    missing = [k for k, n in serve["launches"].items() if n <= 0]
    if missing:
        fail(f"kernels never launched on the served path: {missing}")
    done("serve")
    gc.collect()
    torch.cuda.empty_cache()            # DeepSeek's weights leave the card
    hybrid = hybrid_run("cuda")
    missing = [k for k, n in hybrid["launches"].items() if n <= 0]
    if missing:
        fail(f"kernels never launched on the hybrid path: {missing}")
    done("hybrid")
    gc.collect()
    torch.cuda.empty_cache()            # zamba2's weights leave the card
    dense = dense_run("cuda")
    if dense["launches"]["flash_attention_bh"] <= 0:
        fail("K7 never launched on the dense path")
    done("dense")
    free_card(True)                     # the dense models leave the card
    train = train_run("cuda")
    missing = [k for k, n in train["launches"].items() if n <= 0]
    if missing:
        fail(f"kernels never launched on the train path: {missing}")
    done("train")
    part_res = partitioned_run(res)
    part = part_res["partitioned"]["launches"]
    missing = [k for k in ("spmv_ell_blocked", "spmv_ell_blocked_skip")
               if part[k] <= 0]
    if missing:
        fail(f"kernels never launched on the partitioned path: {missing}")
    done("partitioned and dense")
    verify_phase(res, part_res, on_card=True)
    done("verify")
    elastic = elastic_phase(res, True, ROOT / "chiprun_out")
    missing = [k for k in ELASTIC_KERNELS if elastic["launches"][k] <= 0]
    if missing:
        fail(f"kernels never launched in the elastic phase: {missing}")
    done("elastic")
    cal = calibrate_phase(res, part_res, card_figures(res),
                          ROOT / "chiprun_out" / "calibrate")["launches"]
    missing = [k for k in CALIBRATE_KERNELS if cal[k] <= 0]
    if missing:
        fail(f"kernels never launched in the calibrate phase: {missing}")
    done("calibrate")
    log(f"total {time.perf_counter() - t_start:.1f} s; seconds by phase: "
        + ", ".join(f"{k} {v:.1f}" for k, v in phases.items())
        + f" (the serve phase's adaptive part "
          f"{serve['adaptive']['seconds']:.1f}, its elastic part "
          f"{serve['elastic']['seconds']:.1f})")
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
            elastic_launches=elastic["launches"][name],
            max_abs_err=rec["max_abs_err"],
            **{k: rec[k] for k in timing}))
    # K7 runs on the three serve paths and the train path: its launches
    # are theirs and its times those of its largest DeepSeek prefill call;
    # the dense path's timed calls (gemma3-1b's d 256, qwen2-0.5b's d 64)
    # under "dense", the train path's (its forward in float32 and bf16)
    # under "train"
    paths = (serve, hybrid, dense, train)
    for name, (source, replaces) in {**SERVE_SOURCES,
                                     **HYBRID_SOURCES}.items():
        path = serve if name in SERVE_SOURCES else hybrid
        rec = path["kernels"][name]
        err = max(p["kernels"][name]["max_abs_err"] for p in paths
                  if name in p["kernels"])
        extra = {}
        if name in dense["kernels"]:
            extra["dense_launches"] = dense["launches"][name]
            keys = timing + ("slept_ms",)
            extra["dense"] = {
                arch: {part: {k: t[part][k] for k in keys}
                       for part in ("decode", "window_prefill") if part in t}
                | {"prefill": {k: t[k] for k in keys}}
                for arch, t in dense["kernels"][name]["by_arch"].items()}
            extra["head_dim_probe"] = dense["kernels"][name]["head_dim_probe"]
        if name in train["kernels"]:
            tk = train["kernels"][name]
            extra["train_launches"] = train["launches"][name]
            extra["train_cuda_launches"] = train["cuda_launches"][name]
            extra["train"] = {part: {k: tk[part][k]
                                     for k in timing + ("slept_ms",)}
                              for part in ("train", "train_bf16",
                                           "train_launcher")}
            extra["f32_source"] = "src/repro_torch/csrc/attn_fwd_f32.cuh"
            extra["f32_edge_max_err"] = tk["f32_edge_max_err"]
        records.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(p["launches"].get(name, 0) for p in paths),
            cuda_launches=sum(p["cuda_launches"].get(name, 0)
                              for p in paths),
            elastic_launches=serve["elastic"]["launches"].get(name, 0),
            max_abs_err=err, **{k: rec[k] for k in timing},
            **({"decode": {k: rec["decode"][k] for k in timing}}
               if "decode" in rec else {}),
            **({"split": rec["split"]} if "split" in rec else {}),
            **extra))
    rec = train["kernels"][BWD]
    records.append(dict(
        name=BWD, route="cuda", source=TRAIN_BWD_SOURCE,
        replaces=TRAIN_BWD_REPLACES, launches=train["launches"][BWD],
        cuda_launches=train["cuda_launches"][BWD],
        max_abs_err=rec["max_abs_err"],
        **{k: rec[k] for k in timing + ("slept_ms",)},
        bf16={k: rec["bf16"][k] for k in timing + ("slept_ms",)},
        launcher={k: rec["launcher"][k] for k in timing + ("slept_ms",)}))
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

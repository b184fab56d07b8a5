#!/usr/bin/env python3
"""K7's backward and forward at the training calls, tree against tree.

Run from the repository root on a machine with one NVIDIA GPU::

    python3 bwd_ab.py [--launcher] OLD/src NEW/src [MORE/src ...]

Each argument is the ``src`` directory of a checkout of the port (this
one's is ``src``).  Each tree runs in a process of its own, in the order
given and then in reverse (A, B, B, A).  A process builds its tree's K7
sources and times, as ``chip_smoke.time_bwd_call`` does (device ms from
a cold L2; plain, ``sdpa``, bound; the forward also by CUDA events
behind a device sleep, since the profiler may record none of its
events), the backward and its forward at the training path's calls
(``qwen2-0.5b``, 14 heads of 64, 1,024 tokens, causal, seeded): a
lane-step's ``[14, 1024, 64]`` in float32 and bf16, with the backward's
CUDA kernels one by one (the profiler's mean device ms of each, cold
L2); the same in float32 without the causal mask (twice the pairs, every
block the same work); and the launcher's ``[112, 1024, 64]`` (a batch of
8 in one microbatch) in float32.  With ``--launcher`` a process instead
runs ``repro_torch.launch.train`` at the chip smoke's launcher sizes
(``qwen2-0.5b`` at full width and depth, float32, remat, 8 x 1,024
tokens a step) for ``LAUNCHER_STEPS`` steps without checkpoints, and
records the median ms of steps 2 on.  It prints one JSON line per
process and, last, the mean over each tree's processes.
"""
from __future__ import annotations

import itertools
import json
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import chip_smoke

ROOT = Path(__file__).resolve().parent
LANE, LAUNCHER = (14, 1024, 64), (112, 1024, 64)
# name, dtype, shape, causal
BWD_CALLS = (("float32", "float32", LANE, True),
             ("float32 non-causal", "float32", LANE, False),
             ("float32 launcher", "float32", LAUNCHER, True),
             ("bfloat16", "bfloat16", LANE, True))
CALLS = 23
LAUNCHER_STEPS = 10


def kernel_ms(b: dict) -> dict:
    """Mean device ms of each CUDA kernel of the backward call ``b``, over
    ``CALLS`` calls on its cold copies."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    nbytes, _ = chip_smoke.serve_work(chip_smoke.BWD, b)
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    args = itertools.cycle(chip_smoke.cold_copies(chip_smoke.BWD, b, nbytes,
                                                  l2))
    for _ in range(3):
        chip_smoke.serve_kernel_call(chip_smoke.BWD, next(args))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            chip_smoke.serve_kernel_call(chip_smoke.BWD, next(args))
        torch.cuda.synchronize()
    times: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            m = re.search(r"(\w+(?:<[^()]*>)?)\(", e.name)
            name = m[1] if m else e.name
            times.setdefault(name, []).append(
                (e.time_range.end - e.time_range.start) / 1e3)
    return {n: statistics.fmean(t) for n, t in times.items()}


def one(src: str) -> dict:
    """One tree, in this process."""
    sys.path.insert(0, str(Path(src).resolve()))
    import torch

    from repro_torch.kernels.flash_attention import cuda as fa_cuda

    with ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda lib: lib.build(),
                      (fa_cuda.LIBRARY, fa_cuda.BWD_LIBRARY)))
    out: dict = {"src": src}
    for name, dtype, shape, causal in BWD_CALLS:
        gen = torch.Generator().manual_seed(0)
        q, k, v, do = (torch.randn(shape, generator=gen).to(
            getattr(torch, dtype)).cuda() for _ in range(4))
        a = dict(q=q, k=k, v=v, scale=shape[2] ** -0.5, causal=causal,
                 window=0, kv_len=shape[1], q_offset=0)
        b = chip_smoke.bwd_call(a, do)
        t = chip_smoke.time_bwd_call(b, True)
        f = t["forward"]
        rec = dict(device_ms=t["device_ms"], plain_ms=t["plain_ms"],
                   library_device_ms=t["library_device_ms"],
                   bound_ms=t["bound_ms"],
                   forward_device_ms=f["device_ms"],
                   forward_slept_ms=f["slept_ms"], forward_ms=f["ms"],
                   forward_bound_ms=f["bound_ms"],
                   forward_library_ms=f["library_ms"])
        if shape == LANE and causal:
            rec.update({f"{n} ms": ms for n, ms in kernel_ms(b).items()})
        out[name] = rec
        del q, k, v, do, a, b
    return out


def launcher(src: str) -> dict:
    """The launcher's steps on one tree, in this process."""
    sys.path.insert(0, str(Path(src).resolve()))
    from repro_torch.kernels.flash_attention import cuda as fa_cuda
    from repro_torch.launch import train as launch

    with ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda lib: lib.build(),
                      (fa_cuda.LIBRARY, fa_cuda.BWD_LIBRARY)))
    sizes = chip_smoke.train_sizes(True)
    B, S = sizes["batch"], sizes["seq"]
    hist = launch.main(["--arch", chip_smoke.TRAIN_ARCH, "--steps",
                        str(LAUNCHER_STEPS), "--batch", str(B), "--seq",
                        str(S), "--log-every", str(LAUNCHER_STEPS),
                        "--device", "cuda"])["history"]
    step_ms = statistics.median(h["seconds"] for h in hist[1:]) * 1e3
    return {"src": src,
            "launcher": dict(step_ms=step_ms, tokens_per_s=B * S / step_ms
                             * 1e3, first_step_ms=hist[0]["seconds"] * 1e3,
                             last_loss=hist[-1]["loss"])}


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        run = launcher if argv[1] == "--launcher" else one
        print(json.dumps(run(argv[-1])))
        return 0
    mode = argv[:1] if argv[:1] == ["--launcher"] else []
    argv = argv[len(mode):]
    import torch

    if not argv or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    print(chip_smoke.nvidia_smi_line())
    runs: dict = {src: [] for src in argv}
    for src in argv + argv[::-1]:
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--one", *mode, src], cwd=ROOT,
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        rec = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps(rec), flush=True)
        runs[src].append(rec)

    def mean(values):
        values = [v for v in values if v is not None]
        return statistics.fmean(values) if values else None

    summary = {src: {call: {k: mean(r[call].get(k) for r in recs)
                            for k in recs[0][call]}
                     for call in recs[0] if call != "src"}
               for src, recs in runs.items()}
    print(json.dumps({"mean": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

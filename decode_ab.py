#!/usr/bin/env python3
"""ms per decode step of the port's two served paths, tree against tree.

Run from the repository root on a machine with one NVIDIA GPU::

    python3 decode_ab.py OLD/src NEW/src [MORE/src ...]

Each argument is the ``src`` directory of a checkout of the port (this
one's is ``src``).  Each tree runs in a process of its own, in the order
given and then in reverse (A, B, B, A), so that a drift of the host's
speed over the run falls on every tree alike.  A process builds its
tree's kernels, then for ``zamba2-7b`` and DeepSeek-V2-Lite (``a2a``) at
full size in bf16 (seeded) serves the six requests of ``chip_smoke.py``
after its warm-up, each engine call timed from a device sync to a device
sync, and times K7's decode call at the path's shape (400 keys of a
512-key cache) by its host time: 200 calls back to back, fewer than the
launch queue holds, without a sync.  It prints one JSON line per process
and, last, the mean over each tree's processes.
"""
from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import chip_smoke

ROOT = Path(__file__).resolve().parent
HOST_CALLS = 200


def k7_decode_host_us(cfg, device) -> float:
    """Host us of one K7 decode call at the served path's shape."""
    import torch

    from repro_torch.kernels.flash_attention import ops

    d = cfg.qk_nope_dim + cfg.qk_rope_dim if cfg.mla else cfg.head_dim
    BH = chip_smoke.serve_sizes(True)["slots"] * cfg.n_heads
    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn((BH, T, d), generator=gen, device=device,
                           dtype=torch.bfloat16) for T in (1, 512, 512))
    kw = dict(scale=d ** -0.5, causal=True, window=0, kv_len=401,
              q_offset=400)
    for _ in range(10):
        ops.flash_attention_bh(q, k, v, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        ops.flash_attention_bh(q, k, v, **kw)
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / HOST_CALLS * 1e6


def serve_steps(model, params) -> dict:
    """The six requests of ``chip_smoke.py`` after its warm-up: ms per
    decode step (mean and median) and prefill tokens/s."""
    import torch

    from repro_torch.serve import ServeEngine

    sizes = chip_smoke.serve_sizes(True)
    chip_smoke.warm_up(model, params, sizes)
    eng = ServeEngine(model, params, batch_slots=sizes["slots"],
                      max_len=sizes["max_len"])
    times: dict = {"prefill": [], "decode": []}
    tokens = []

    def timed(kind, fn):
        def call(p, inputs, *rest):
            if kind == "prefill":
                tokens.append(inputs["tokens"].numel())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(p, inputs, *rest)
            torch.cuda.synchronize()
            times[kind].append(time.perf_counter() - t0)
            return out
        return call

    eng._prefill = timed("prefill", eng._prefill)
    eng._decode = timed("decode", eng._decode)
    for r in chip_smoke.serve_requests(model.cfg.vocab, sizes):
        eng.submit(r)
    eng.run_until_drained()
    dec = [1e3 * s for s in times["decode"]]
    return dict(decode_steps=len(dec), decode_ms=statistics.fmean(dec),
                decode_ms_median=statistics.median(dec),
                prefill_tok_s=sum(tokens) / sum(times["prefill"]))


def one(src: str) -> dict:
    """One tree, in this process."""
    sys.path.insert(0, str(Path(src).resolve()))
    import torch

    from repro_torch import configs
    from repro_torch.core.costmodel import LASSEN
    from repro_torch.models import Mesh, Model

    chip_smoke.build_kernels()
    out: dict = {"src": src}
    for arch in (chip_smoke.HYBRID_ARCH, chip_smoke.SERVE_ARCH):
        cfg = configs.get(arch)
        kw = ({} if arch == chip_smoke.HYBRID_ARCH else dict(
            mesh=Mesh(*chip_smoke.SERVE_MESH), moe_mode="a2a",
            moe_cap_factor=1.25, machine_params=LASSEN))
        model = Model(cfg, device="cuda", **kw)
        params = model.init_params(seed=chip_smoke.SERVE_SEED)
        rec = serve_steps(model, params)
        rec["k7_decode_host_us"] = k7_decode_host_us(cfg, "cuda")
        out[arch] = rec
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(one(argv[1])))
        return 0
    import torch

    if not argv or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    print(chip_smoke.nvidia_smi_line())
    runs: dict = {src: [] for src in argv}
    for src in argv + argv[::-1]:
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--one", src], cwd=ROOT, capture_output=True,
                             text=True)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        rec = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps(rec), flush=True)
        runs[src].append(rec)
    summary = {src: {arch: {k: statistics.fmean(r[arch][k] for r in recs)
                            for k in recs[0][arch]}
                     for arch in recs[0] if arch != "src"}
               for src, recs in runs.items()}
    print(json.dumps({"mean": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

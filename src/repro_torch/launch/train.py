"""Training launcher: config -> model -> data -> train step -> checkpoints.

Ported from ``repro.launch.train``: float32 weights, AdamW with a warmup
of ``max(2, steps // 20)`` steps, the seeded ``TokenStream``, a
``CheckpointManager(keep=3)`` with restore-latest and resume, a
``StragglerDetector`` over this one host, and the same log lines.  It runs
on ``cuda`` unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --steps 50 --batch 8 --seq 256 --reduced --ckpt build/ck

:func:`main` takes the arguments as a list as well, and returns the final
state with each step's loss, learning rate, gradient norm and seconds
(host clock around the step, which ends when its loss is read), so that a
caller can drive the launcher in process.  The last step's checkpoint is
written once (``repro`` writes it a second time when ``--ckpt-every``
divides ``--steps``, and again on a run resumed at its end), and an
in-flight save is waited for even when a step raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--vocab", type=int, default=0,
                    help="override vocab (speeds up CPU demos)")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)

    from .. import configs
    from ..models import Model
    from ..runtime import CheckpointManager, StragglerDetector
    from ..train import (
        AdamWConfig, DataConfig, TokenStream, TrainerConfig,
        make_train_state, make_train_step,
    )

    cfg = configs.reduced(args.arch) if args.reduced else configs.get(args.arch)
    if args.vocab:
        cfg = dataclasses.replace(cfg, vocab=args.vocab)
    cfg = dataclasses.replace(cfg, dtype=torch.float32)

    model = Model(cfg, device=args.device)
    device = model.device
    tcfg = TrainerConfig(
        opt=AdamWConfig(lr=args.lr, warmup_steps=max(2, args.steps // 20),
                        total_steps=args.steps),
        microbatches=args.microbatches,
        compress_grads=args.compress_grads,
    )
    data = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch))
    step_fn = make_train_step(model, tcfg)
    state = make_train_state(model, tcfg, seed=0)
    start = 0
    mgr = None
    if args.ckpt:
        mgr = CheckpointManager(args.ckpt, keep=3)
        got = mgr.restore_latest(state)
        if got is not None:
            start, state = got
            print(f"[train] resumed from step {start}")

    det = StragglerDetector(n_hosts=1)
    n_params = cfg.param_count()
    print(f"[train] arch={cfg.name} params={n_params:,} steps={args.steps}")
    history: List[Dict] = []
    t_last = time.time()
    try:
        for i in range(start, args.steps):
            batch = {k: torch.as_tensor(v, device=device)
                     for k, v in data.global_batch_at(i).items()}
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            history.append(dict(step=i + 1, loss=loss,
                                lr=float(metrics["lr"]),
                                gnorm=float(metrics["gnorm"]),
                                seconds=time.perf_counter() - t0))
            if mgr and (i + 1) % args.ckpt_every == 0:
                mgr.save(i + 1, state)
            if (i + 1) % args.log_every == 0 or i == start:
                dt = time.time() - t_last
                t_last = time.time()
                det.update(np.array([dt]))
                tps = args.batch * args.seq * args.log_every / max(dt, 1e-9)
                print(f"[train] step {i + 1:5d} loss={loss:.4f} "
                      f"lr={history[-1]['lr']:.2e} "
                      f"gnorm={history[-1]['gnorm']:.2f} tok/s={tps:,.0f}")
        if mgr and history and args.steps % args.ckpt_every:
            mgr.save(args.steps, state)
    finally:
        if mgr:
            mgr.wait()
    print("[train] done")
    return dict(state=state, history=history, start=start,
                n_params=n_params, config=cfg)


if __name__ == "__main__":
    main()

"""Synthetic-but-structured LM data pipeline.

A copy of ``repro.train.data`` (numpy only): the same seeds give the same
batches, bit for bit.

Deterministic, seekable, shardable: every (step, data_shard) pair maps to a
unique slice of an infinite token stream, so restarts resume exactly and
elastic re-shards (different data-parallel size) never replay or skip data.
The stream is a mixture of Zipfian unigrams + repeated n-gram motifs so a
~100M model shows a real, declining loss curve (used by examples/train_lm).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    motif_len: int = 16
    n_motifs: int = 512
    motif_prob: float = 0.5


class TokenStream:
    """Stateless sampler: sample(step, shard, n_shards) -> (tokens, labels)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # motif table: recurring phrases the model can learn to complete
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self.probs = probs / probs.sum()
        self.motifs = rng.integers(
            0, cfg.vocab, size=(cfg.n_motifs, cfg.motif_len)
        ).astype(np.int32)

    def _sample_doc(self, rng: np.random.Generator, length: int) -> np.ndarray:
        out = np.empty(length + 1, dtype=np.int32)
        i = 0
        while i < length + 1:
            if rng.random() < self.cfg.motif_prob:
                m = self.motifs[rng.integers(self.cfg.n_motifs)]
                take = min(len(m), length + 1 - i)
                out[i: i + take] = m[:take]
                i += take
            else:
                n = int(rng.integers(4, 32))
                take = min(n, length + 1 - i)
                out[i: i + take] = rng.choice(
                    self.cfg.vocab, size=take, p=self.probs
                )
                i += take
        return out

    def sample(
        self, step: int, shard: int, n_shards: int
    ) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        assert cfg.global_batch % n_shards == 0
        per = cfg.global_batch // n_shards
        toks = np.empty((per, cfg.seq_len), dtype=np.int32)
        labels = np.empty((per, cfg.seq_len), dtype=np.int32)
        for row in range(per):
            global_row = step * cfg.global_batch + shard * per + row
            rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, 7919, global_row])
            )
            doc = self._sample_doc(rng, cfg.seq_len)
            toks[row] = doc[:-1]
            labels[row] = doc[1:]
        return {"tokens": toks, "labels": labels}

    def global_batch_at(self, step: int) -> Dict[str, np.ndarray]:
        return self.sample(step, 0, 1)


class Prefetcher:
    """Background-thread double-buffered prefetch of host batches."""

    def __init__(self, stream: TokenStream, n_shards: int = 1,
                 shard: int = 0, depth: int = 2):
        import queue
        import threading

        self.stream = stream
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            step = 0
            while not self._stop.is_set():
                batch = stream.sample(step, shard, n_shards)
                self.q.put((step, batch))
                step += 1

        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def __iter__(self):
        while True:
            yield self.q.get()

    def close(self):
        self._stop.set()
        try:
            self.q.get_nowait()
        except Exception:
            pass

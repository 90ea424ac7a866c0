"""Synthetic sharded LM data pipeline.

The port's own copy of ``src/repro/data/pipeline.py`` (numpy only; the
port imports nothing of the reference). Batch ``step`` is a pure function
of (seed, step, host slice), drawn from a numpy ``SeedSequence``, so a
restarted job resumes mid-epoch with no coordination and both packages
train on the same arrays, bit for bit.

The token stream mixes Zipf-distributed unigrams with short arithmetic
runs (t, t+1, ..., t+7), so a smoke training run has structure to learn. A
background thread prefetches ``prefetch`` batches ahead of the loop.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

__all__ = ["DataConfig", "SyntheticLM"]


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    motif_frac: float = 0.5  # fraction of positions covered by learnable motifs


class SyntheticLM:
    """Host-sharded synthetic corpus. ``host_index``/``host_count`` slice the
    global batch; every host generates only its rows (no cross-host IO)."""

    def __init__(self, cfg: DataConfig, host_index: int = 0, host_count: int = 1):
        if cfg.global_batch % host_count:
            raise ValueError(f"global batch {cfg.global_batch} does not split "
                             f"over {host_count} hosts")
        self.cfg = cfg
        self.host_index = host_index
        self.host_count = host_count
        self.local_batch = cfg.global_batch // host_count
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._p = p / p.sum()

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Batch for ``step``: tokens (local_batch, seq_len+1) -> inputs/labels."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, self.host_index]))
        n = cfg.seq_len + 1
        toks = rng.choice(cfg.vocab, size=(self.local_batch, n), p=self._p)
        n_motifs = max(1, int(cfg.motif_frac * n / 8))
        for b in range(self.local_batch):
            starts = rng.integers(0, max(1, n - 8), size=n_motifs)
            bases = rng.integers(0, cfg.vocab - 8, size=n_motifs)
            for s, base in zip(starts, bases):
                toks[b, s:s + 8] = base + np.arange(8)
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def iter(self, start_step: int = 0, prefetch: int = 2) -> Iterator[Dict]:
        """Prefetching iterator, resumable from any step."""
        q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def producer():
            s = start_step
            while not stop.is_set():
                q.put(self.batch(s))
                s += 1

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()

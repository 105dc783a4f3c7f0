"""Deterministic synthetic data pipeline with per-host sharding and
prefetch, the JAX package's ``data/pipeline.py`` (pure numpy, so the
port keeps its own copy and gives bitwise the same batches).

Batches are a pure function of (seed, step, shard), so checkpoint-resume
is exact (the loop re-requests step k) and a restart with another host
count re-shards deterministically.  A background thread keeps
``prefetch`` batches ready; it ends when the iterator is closed.

The token stream mixes structured patterns (repeats, arithmetic
sequences mod vocab) with noise, so that a small LM has something to
learn while the data stays synthetic and offline.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator

import numpy as np

from repro_torch.models.common import ModelConfig


class SyntheticLM:
    """step -> {"tokens": (B_local, S) int32, optional "memory" (B_local,
    P, D) f32 for the vision and audio families}, numpy arrays."""

    def __init__(self, cfg: ModelConfig, seq_len: int, global_batch: int,
                 seed: int = 0, shard: int = 0, num_shards: int = 1):
        assert global_batch % num_shards == 0
        self.cfg = cfg
        self.seq_len = seq_len
        self.local_batch = global_batch // num_shards
        self.seed = seed
        self.shard = shard
        self.num_shards = num_shards

    def batch(self, step: int) -> Dict[str, Any]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard]))
        b, s, v = self.local_batch, self.seq_len, self.cfg.vocab
        kind = rng.integers(0, 3, size=(b,))
        # pattern 0: repeated motif; 1: arithmetic sequence; 2: uniform noise
        motif_len = int(rng.integers(3, 9))
        motif = rng.integers(0, v, size=(b, motif_len))
        reps = int(np.ceil(s / motif_len))
        toks_rep = np.tile(motif, (1, reps))[:, :s]
        start = rng.integers(0, v, size=(b, 1))
        stride = rng.integers(1, 7, size=(b, 1))
        toks_arith = (start + stride * np.arange(s)[None, :]) % v
        toks_noise = rng.integers(0, v, size=(b, s))
        toks = np.where(kind[:, None] == 0, toks_rep,
                        np.where(kind[:, None] == 1, toks_arith, toks_noise))
        out = {"tokens": toks.astype(np.int32)}
        if self.cfg.family == "vlm":
            out["memory"] = rng.standard_normal(
                (b, self.cfg.num_patches, self.cfg.d_model),
                np.float32) * 0.02
        elif self.cfg.family == "audio":
            out["memory"] = rng.standard_normal(
                (b, max(s // self.cfg.enc_ratio, 1), self.cfg.d_model),
                np.float32) * 0.02
        return out

    def iterator(self, start_step: int = 0, prefetch: int = 2
                 ) -> Iterator[Dict[str, Any]]:
        """Background-prefetching iterator starting at ``start_step``.
        ``close()`` it (or let a ``for`` loop finish with it): the worker
        thread is stopped and joined."""
        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def worker():
            step = start_step
            while not stop.is_set():
                item = self.batch(step)
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
                step += 1

        th = threading.Thread(target=worker, daemon=True,
                              name="SyntheticLM-prefetch")
        th.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
            th.join()

"""Deterministic, checkpointable data pipeline (numpy; no torch needed).

The JAX package's ``data/pipeline.py``, kept as its own copy here (the
port imports nothing of that package): for the same ``DataConfig``,
step, rank and world, every batch is bit for bit the JAX package's.

Every batch is a pure function of (seed, step), so

* any worker can reproduce any batch (no shared queue to lose on failure),
* resume-from-checkpoint is bitwise exact (the iterator state is one int),
* each data-parallel rank slices its shard of the global batch by rank id.

Two sources: a hash-based synthetic corpus (default; zipfian-ish marginals
so losses behave like text), and an optional memory-mapped token file.
A background prefetch thread keeps ``depth`` batches ready.  Batches stay
numpy; the trainer moves them to its device.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    token_file: Optional[str] = None  # memory-mapped corpus (uint32)
    frames_dim: int = 0               # >0: also emit encoder frames (encdec)


def _batch_rng(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, 0xD47A]))


def synthetic_batch(cfg: DataConfig, step: int, rank: int = 0,
                    world: int = 1) -> Dict[str, np.ndarray]:
    """Batch `step`, slice `rank`-of-`world` along the batch dim."""
    assert cfg.global_batch % world == 0
    per = cfg.global_batch // world
    rng = _batch_rng(cfg, step)
    # zipf-ish marginal over the vocab, deterministic per step
    z = rng.zipf(1.3, size=(cfg.global_batch, cfg.seq_len + 1))
    tokens_all = (z % (cfg.vocab - 2)).astype(np.int32) + 1
    sl = slice(rank * per, (rank + 1) * per)
    out = {"tokens": tokens_all[sl, :-1], "labels": tokens_all[sl, 1:]}
    if cfg.frames_dim:
        out["frames"] = rng.standard_normal(
            (cfg.global_batch, cfg.seq_len, cfg.frames_dim)
        )[sl].astype(np.float32) * 0.02
    return out


def file_batch(cfg: DataConfig, step: int, rank: int = 0, world: int = 1,
               _mmap_cache: dict = {}) -> Dict[str, np.ndarray]:
    toks = _mmap_cache.get(cfg.token_file)
    if toks is None:
        toks = np.memmap(cfg.token_file, dtype=np.uint32, mode="r")
        _mmap_cache[cfg.token_file] = toks
    per = cfg.global_batch // world
    rng = _batch_rng(cfg, step)
    n_windows = len(toks) - cfg.seq_len - 1
    starts = rng.integers(0, n_windows, size=cfg.global_batch)
    sl = starts[rank * per:(rank + 1) * per]
    rows = np.stack([np.asarray(toks[s:s + cfg.seq_len + 1]) for s in sl])
    rows = (rows % cfg.vocab).astype(np.int32)
    return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


def get_batch(cfg: DataConfig, step: int, rank: int = 0, world: int = 1):
    if cfg.token_file:
        return file_batch(cfg, step, rank, world)
    return synthetic_batch(cfg, step, rank, world)


class PrefetchingLoader:
    """Iterator with a prefetch thread; state = the next step index."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, depth: int = 2,
                 rank: int = 0, world: int = 1):
        self.cfg = cfg
        self.rank, self.world = rank, world
        self._next_step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._fetch_step = start_step
        self._thread.start()

    def _work(self):
        while not self._stop.is_set():
            batch = get_batch(self.cfg, self._fetch_step, self.rank, self.world)
            step = self._fetch_step
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.2)
                    break
                except queue.Full:
                    continue
            self._fetch_step += 1

    def __next__(self):
        step, batch = self._q.get()
        # guard against raced restarts: regenerate if out of order
        if step != self._next_step:
            batch = get_batch(self.cfg, self._next_step, self.rank, self.world)
        self._next_step += 1
        return batch

    @property
    def state(self) -> int:
        """Checkpointable iterator state: the next step to consume."""
        return self._next_step

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

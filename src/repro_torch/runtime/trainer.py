"""Fault-tolerant training loop, on the card unless the caller asks for
the CPU.

The JAX package's ``runtime/trainer.py``, with the same behaviours:

* **auto-resume**: on start, restore the newest valid checkpoint
  (parameters, optimizer state, data-iterator state) and continue bit for
  bit as the uninterrupted run would have;
* **periodic async checkpoints** and a final sync one;
* **straggler detection**: per-step wall times against the median of a
  window; a slow step is recorded and reported through a callback;
* **simulated failures**: ``failure_hook`` may raise at any step, to test
  the restart.

Bitwise resume needs every step to be deterministic on the card too: the
step's kernels and their backwards add in a fixed order (B5's backward by a
segmented scan, not a float ``index_add_``; the embedding gather's backward
is PyTorch's sort-based ``index_put_``), and the products go to cuBLAS on
one stream.  The int8 error-feedback all-reduce of the JAX package's
trainer comes with the multi-device side of the port.
"""

from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..ckpt.manager import CheckpointManager
from ..data.pipeline import DataConfig, PrefetchingLoader
from ..device import resolve_device
from ..launch import steps as steps_mod
from ..models import Model
from ..optim import adamw


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclass
class TrainConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    log_every: int = 10
    straggler_window: int = 20
    straggler_factor: float = 3.0  # step > factor * median => straggler
    ckpt_dir: str = field(default_factory=_default_ckpt_dir)
    keep: int = 3


@dataclass
class TrainState:
    params: Any
    opt: adamw.AdamWState
    step: int
    data_state: int


class StragglerMonitor:
    def __init__(self, window: int, factor: float):
        self.times: List[float] = []
        self.window = window
        self.factor = factor
        self.flagged: List[int] = []

    def record(self, step: int, dt: float) -> bool:
        self.times.append(dt)
        hist = self.times[-self.window:]
        if len(hist) >= 5:
            med = float(np.median(hist))
            if dt > self.factor * med:
                self.flagged.append(step)
                return True
        return False


def train(model: Model, data_cfg: DataConfig, train_cfg: TrainConfig,
          opt_cfg: Optional[adamw.AdamWConfig] = None,
          failure_hook: Optional[Callable[[int], None]] = None,
          on_straggler: Optional[Callable[[int, float], None]] = None,
          seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Run (or resume) training on ``device`` (raises without a card unless
    ``device="cpu"``).  Returns the JAX package's metrics -- ``losses``,
    ``final_step``, ``stragglers``, ``params``, ``opt`` -- and beside them
    ``step_seconds`` (each step's wall, the loss read back included) and
    ``final_save_seconds`` (the final sync checkpoint)."""
    device = resolve_device(device)
    opt_cfg = opt_cfg or adamw.AdamWConfig(total_steps=train_cfg.total_steps)
    mgr = CheckpointManager(train_cfg.ckpt_dir, keep=train_cfg.keep)
    step_fn = steps_mod.make_train_step(model, opt_cfg)

    # ---- init or resume ----------------------------------------------------
    params = model.init(torch.Generator(device=device).manual_seed(seed),
                        device=device)
    opt = adamw.init(params)
    start_step, data_state = 0, 0
    latest = mgr.latest_step()
    if latest is not None:
        (params, opt), meta = mgr.restore((params, opt))
        start_step = int(meta["step"])
        data_state = int(meta.get("data_state", start_step))

    loader = PrefetchingLoader(data_cfg, start_step=data_state)
    monitor = StragglerMonitor(train_cfg.straggler_window,
                               train_cfg.straggler_factor)
    losses: List[float] = []
    try:
        for step in range(start_step, train_cfg.total_steps):
            if failure_hook is not None:
                failure_hook(step)  # may raise to simulate a node loss
            batch = next(loader)
            t0 = time.perf_counter()
            loss, params, opt = step_fn(params, opt, batch)
            loss = float(loss)
            dt = time.perf_counter() - t0
            losses.append(loss)
            if monitor.record(step, dt) and on_straggler:
                on_straggler(step, dt)
            next_step = step + 1
            if next_step % train_cfg.ckpt_every == 0:
                mgr.save(next_step, (params, opt),
                         {"step": next_step, "data_state": loader.state},
                         block=False)
            if step % train_cfg.log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} {dt*1e3:.0f}ms")
        t0 = time.perf_counter()
        mgr.save(train_cfg.total_steps, (params, opt),
                 {"step": train_cfg.total_steps, "data_state": loader.state},
                 block=True)
        final_save = time.perf_counter() - t0
    finally:
        loader.close()
        mgr.wait()
    return {
        "losses": losses,
        "final_step": train_cfg.total_steps,
        "stragglers": monitor.flagged,
        "params": params,
        "opt": opt,
        "step_seconds": monitor.times,
        "final_save_seconds": final_save,
    }

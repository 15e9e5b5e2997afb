"""Fault-tolerant checkpointing, on the JAX package's on-disk layout.

* **Logical state**: a checkpoint stores a name -> array dict (the state's
  nested dicts, lists and ``NamedTuple``s flattened into ``/``-joined
  names, as the JAX package's ``ckpt/manager.py`` names them) and its
  metadata (step, data-iterator state).  A checkpoint written by either
  package restores in the other: ``step_%010d/shard_00000.npz``,
  ``meta.json`` and the ``META`` marker, and bfloat16 leaves stored as
  ``uint16`` under a ``::bf16`` tag (numpy has no bfloat16; the bits go
  through an ``int16`` view, so nothing here needs ``ml_dtypes``).
* **Atomicity**: written to ``<dir>/tmp.<step>.<pid>/``, fsynced, then
  ``os.rename``-d to ``step_<n>`` -- a crash mid-save never corrupts the
  latest checkpoint.
* **Async**: ``save(..., block=False)`` copies the state to host memory
  before it returns (the trainer updates its tensors in place right
  after) and writes in a background thread.
* **GC**: keep the newest ``keep`` checkpoints.

* **Elastic restore**: the logical state does not depend on a mesh, so
  ``restore(..., shardings=)`` places each leaf onto whatever
  ``DeviceMesh`` the restoring job runs (a ``DTensor`` per leaf) -- the
  JAX package's ``device_put`` onto a ``NamedSharding``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

BF16_TAG = "::bf16"
# The JAX package names a host's shard by its process index; the port runs
# in one process, so it writes the first host's name (and reads any).
SHARD = "shard_00000.npz"


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}/{i}"))
    elif hasattr(tree, "_fields"):  # NamedTuple
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k),
                                f"{prefix}/{k}" if prefix else k))
    else:
        out[prefix] = tree
    return out


def _unflatten_into(template: Any, flat: Dict[str, Any], prefix: str = ""):
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat,
                                   f"{prefix}/{k}" if prefix else str(k))
                for k, v in template.items()}
    if hasattr(template, "_fields"):
        vals = [_unflatten_into(getattr(template, k), flat,
                                f"{prefix}/{k}" if prefix else k)
                for k in template._fields]
        return type(template)(*vals)
    if isinstance(template, (list, tuple)):
        return type(template)(
            _unflatten_into(v, flat, f"{prefix}/{i}")
            for i, v in enumerate(template))
    device = template.device if isinstance(template, torch.Tensor) else "cpu"
    return flat[prefix].to(device)


def to_host(leaf) -> Tuple[str, np.ndarray]:
    """``(tag, array)``: a tensor copied to host memory as numpy, bfloat16
    as its bits in ``uint16`` with the ``::bf16`` tag."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)   # a snapshot, never a view
        if t.dtype == torch.bfloat16:
            return BF16_TAG, t.view(torch.int16).numpy().view(np.uint16)
        return "", t.numpy()
    return "", np.asarray(leaf)


def from_host(array: np.ndarray, tag: str) -> torch.Tensor:
    """The inverse of :func:`to_host`, on the CPU."""
    if tag == BF16_TAG:
        bits = np.ascontiguousarray(array).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(array))


@dataclass
class CheckpointManager:
    directory: str
    keep: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- paths ---------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def all_steps(self):
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_"):
                if os.path.exists(os.path.join(self.directory, name, "META")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save ----------------------------------------------------------------
    def _write(self, step: int, host_state: Dict[str, np.ndarray],
               meta: Dict[str, Any]):
        tmp = os.path.join(self.directory, f"tmp.{step}.{os.getpid()}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, SHARD), **host_state)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        # fsync the directory contents before the atomic publish
        for name in os.listdir(tmp):
            fd = os.open(os.path.join(tmp, name), os.O_RDONLY)
            os.fsync(fd)
            os.close(fd)
        with open(os.path.join(tmp, "META"), "w") as f:
            f.write("ok")
        final = self._step_dir(step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        # clean stale tmp dirs from crashed saves
        for name in os.listdir(self.directory):
            if name.startswith("tmp."):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    def save(self, step: int, state: Any, extra_meta: Optional[Dict] = None,
             block: bool = True):
        """Snapshot to host memory, then write (in a background thread
        unless ``block``)."""
        host = {}
        for k, v in _flatten(state).items():
            tag, a = to_host(v)
            host[k + tag] = a
        meta = {"step": step, "time": time.time(),
                "keys": sorted(host.keys()), **(extra_meta or {})}
        self.wait()
        if block:
            self._write(step, host, meta)
        else:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, meta), daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- restore -------------------------------------------------------------
    def restore(self, template: Any, step: Optional[int] = None,
                shardings: Any = None) -> Tuple[Any, Dict[str, Any]]:
        """Restore into ``template``'s structure (the newest checkpoint
        unless ``step`` is given): a tensor for every leaf, on the device of
        the template's leaf (the CPU where the leaf is not a tensor), in the
        dtype it was saved in.  With ``shardings`` -- a tree like
        ``template`` whose leaves are ``(DeviceMesh, placements)`` pairs --
        each leaf is distributed onto its mesh instead (every rank of the
        mesh calls this): the elastic-rescale path."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoint found")
        d = self._step_dir(step)
        flat: Dict[str, torch.Tensor] = {}
        for name in sorted(os.listdir(d)):
            if name.startswith("shard_"):
                with np.load(os.path.join(d, name)) as z:
                    for k in z.files:
                        if k.endswith(BF16_TAG):
                            flat[k[:-len(BF16_TAG)]] = from_host(z[k],
                                                                 BF16_TAG)
                        else:
                            flat[k] = from_host(z[k], "")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        state = _unflatten_into(template, flat)
        if shardings is not None:
            state = _distribute(state, shardings)
        return state, meta


def _distribute(state: Any, shardings: Any) -> Any:
    """``distribute_tensor`` over every tensor leaf of ``state`` with the
    ``(mesh, placements)`` pair at the same place in ``shardings``."""
    if isinstance(state, torch.Tensor):
        from torch.distributed.tensor import distribute_tensor

        mesh, places = shardings
        return distribute_tensor(state.to(mesh.device_type), mesh,
                                 list(places))
    if isinstance(state, dict):
        return {k: _distribute(v, shardings[k]) for k, v in state.items()}
    if hasattr(state, "_fields"):
        return type(state)(*(_distribute(getattr(state, k),
                                         getattr(shardings, k))
                             for k in state._fields))
    return type(state)(_distribute(v, s) for v, s in zip(state, shardings))

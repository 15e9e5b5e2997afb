"""PyTorch/CUDA port of the memory-partitioning system, beside the JAX
package ``repro`` (the reference).  Same sub-package layout; imports
``torch``, never ``jax`` and nothing of ``repro``.

Ported so far: the banking math and solver (``core``), the plan plane
(planner, plan store, planning service with plan tickets, joint planning,
telemetry, tracing and the remote solve fabric in ``core``, its worker in
``launch.solve_worker``; tenancy in ``runtime.tenancy``; the certifier and
lint in ``analysis``), the executable artifact with its banked
gather/scatter CUDA kernels (``core.artifact``, ``kernels``), the
architecture configs, the prefill and decode paths of every model family
(``models``; the MoE dispatch, the SSD chunk and the flash attention are
CUDA kernels too; the ring-banked and int8 KV-cache decode variants of the
dense transformer), and the continuous-batching decode server on plan
tickets (``runtime.server``, ``launch.serve``) and a fleet of them over one
plan plane (``launch.serve_fleet``), and training: every family's loss
with gradients through the kernels' autograd functions, a hand-written
AdamW (``optim``), the data pipeline (``data``), checkpoints (``ckpt``),
the trainer (``runtime.trainer``) and its launcher (``launch.train``).
Entry points run on ``cuda`` and raise when there is no card unless the
caller passes ``device="cpu"``.
"""

from . import convert, core
from .device import resolve_device

__all__ = ["convert", "core", "resolve_device"]

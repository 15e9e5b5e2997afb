"""PyTorch/CUDA port of the memory-partitioning system, beside the JAX
package ``repro`` (the reference).  Same sub-package layout; imports
``torch``, never ``jax`` and nothing of ``repro``.

Ported so far: the banking math and solver (``core``), the executable
artifact with its banked gather/scatter CUDA kernels (``core.artifact``,
``kernels``), the architecture configs, the dense transformer's decode
path (``models``) and the continuous-batching decode server
(``runtime.server``, ``launch.serve``).  Entry points run on ``cuda``
and raise when there is no card unless the caller passes ``device="cpu"``.
"""

from . import convert, core
from .device import resolve_device

__all__ = ["convert", "core", "resolve_device"]

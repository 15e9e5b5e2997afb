"""Production and host meshes.

``make_production_mesh`` describes the JAX package's production meshes
(16x16 ``("data", "model")`` chips a pod, 2x16x16 with a leading pure-DP
``"pod"`` axis) without allocating anything: the sharding rules read only a
mesh's axis names and sizes, and no single machine holds 256 devices.
``make_host_mesh`` is the live one: a ``DeviceMesh`` of shape ``(1, world)``
over the process group this process has joined.  Neither starts a process
group; the caller does (``torch.distributed.init_process_group``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class MeshShape:
    """A mesh by its axes alone: ``axis_names`` major to minor, ``shape``
    their sizes by name -- what the sharding rules and the dry-run read."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16x16 = 256 devices a pod ('data', 'model'); 2 pods = 512 with a
    leading pure-DP 'pod' axis that crosses the slow inter-pod links
    exactly once per step (the gradient all-reduce)."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_host_mesh(device="cuda"):
    """A ``DeviceMesh`` of shape ``(1, world)`` named ``("data",
    "model")`` over the default process group: every rank on the model
    axis, as the JAX package's host mesh puts every local device there.
    ``device`` is the mesh's device type (``"cuda"`` or ``"cpu"``)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    return DeviceMesh(torch.device(device).type,
                      torch.arange(world).reshape(1, world),
                      mesh_dim_names=("data", "model"))

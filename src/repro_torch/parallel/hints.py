"""Named activation-sharding hints.

Models call ``hint(x, "residual")`` at layout-critical points; the trainer
or the dry-run installs a policy mapping hint names to partition specs for
the current (arch x shape x mesh) cell.  Without a policy the calls are
no-ops, so single-device runs are untouched.  The policy is per thread,
as in the JAX package.

This is the activation-side twin of the parameter banking bridge
(``parallel/sharding.py``).  On a ``DTensor`` a hint redistributes to the
spec's placements on the tensor's own mesh -- the JAX package's
``with_sharding_constraint``; a plain tensor has no layout to constrain
and passes through.  Entries that are not specs (``"__mesh__"``, the live
``DeviceMesh`` the expert-parallel MoE layer reads, and ``"__fsdp__"``)
are read with :func:`policy_value`.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Optional

_LOCAL = threading.local()


def _policy() -> Optional[Dict[str, object]]:
    return getattr(_LOCAL, "policy", None)


@contextmanager
def sharding_policy(policy: Dict[str, object]):
    old = _policy()
    _LOCAL.policy = policy
    try:
        yield
    finally:
        _LOCAL.policy = old


def hint(x, name: str):
    pol = _policy()
    if pol is None:
        return x
    spec = pol.get(name)
    if spec is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    from .sharding import placements

    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


def policy_value(name: str, default=None):
    """Non-spec policy entries (e.g. ``'__mesh__'`` for the expert-parallel
    MoE layer)."""
    pol = _policy()
    if pol is None:
        return default
    return pol.get(name, default)

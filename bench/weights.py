"""The benchmark's own random weights, drawn on the device from the seed.

The program says only which leaves its parameter tree has, with their
shapes and dtypes (its ``init`` on the ``meta`` device, which draws
nothing); every value comes from here, one draw a leaf in the leaf's own
dtype, in the order of the leaves' paths.  The scales are the usual
initialisations: a matrix ``N(0, 1 / fan_in)`` with ``fan_in`` its
second-to-last dim, embeddings ``N(0, 0.02^2)``, gains and biases a little
off their neutral value so that a path that dropped them would show, and
a Mamba2 block's ``A_log``, ``dt_bias`` and ``D_skip`` as Mamba2 draws
them (``A`` uniform in [1, 16]; ``dt`` log-uniform in the configuration's
``time_step_min``..``time_step_max``; ``D`` one).
"""

from __future__ import annotations

import math

import numpy as np
import torch

GAINS = {"ln", "ln1", "ln2", "ln_f", "gate_ln", "conv_b"}
EMBEDDINGS = {"embed", "lm_head"}


def derive(seed: int, purpose: str) -> int:
    """A 63-bit seed for one use of ``seed`` (weights, traffic, ...)."""
    words = [seed % 2**64 >> 32, seed % 2**32] + list(purpose.encode())
    return int(np.random.SeedSequence(words).generate_state(
        1, dtype=np.uint64)[0] >> np.uint64(1))


def leaves(tree, prefix=""):
    """``(path, leaf)`` of a nested dict, sorted by path."""
    out = []
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            out += leaves(tree[k], path)
        else:
            out.append((path, tree[k]))
    return out


def _draw(path, meta, gen, device, ssm):
    name = path.rsplit("/", 1)[-1]
    shape, dtype = tuple(meta.shape), meta.dtype
    if name == "A_log":
        u = torch.rand(shape, generator=gen, device=device)
        return torch.log(1.0 + 15.0 * u).to(dtype)
    if name == "dt_bias":
        lo, hi = math.log(ssm["time_step_min"]), math.log(ssm["time_step_max"])
        dt = torch.exp(lo + (hi - lo) * torch.rand(shape, generator=gen,
                                                   device=device))
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)  # softplus^-1
    if name == "D_skip":
        return torch.ones(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    if name in GAINS:
        return w.mul_(0.05)
    if name in EMBEDDINGS:
        return w.mul_(0.02)
    if len(shape) < 2:
        raise ValueError(f"no rule draws the leaf {path} {shape}")
    return w.mul_(1.0 / math.sqrt(shape[-2]))


def draw(shapes: dict, seed: int, device, ssm: dict | None = None) -> dict:
    """A tree like ``shapes`` (leaves on ``meta``) of values drawn from
    ``seed`` on ``device``; ``ssm`` gives the Mamba2 ``time_step_min`` and
    ``time_step_max``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "weights"))
    out: dict = {}
    for path, meta in leaves(shapes):
        node = out
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = _draw(path, meta, gen, device, ssm or {})
    return out

"""Tiny stand-ins of the cells' configurations and mixes, small enough for
a CPU test: the same families, paths and drivers at toy widths.  Their
limits (``tiny_limits.json``, the same numbers the cells compare) were set
between the program's largest reading on 12 seeds and its float8
control's smallest on 4, at these sizes on the CPU; at toy width a routing
flip moves a top-2-of-8 MoE layer by half, so the MoE cells' worst-case
numbers sit close to the control's there."""

from __future__ import annotations

import json
import time
from pathlib import Path

ARCH = {
    "moe": dict(name="tiny-moe", family="moe", n_layers=2, d_model=256,
                n_heads=4, n_kv_heads=2, head_dim=64, d_ff=64, vocab=512,
                n_experts=8, top_k=2, moe_d_ff=64, shared_expert=False,
                capacity_factor=1.25, rope_theta=10000.0, norm_eps=1e-6,
                tie_embeddings=False),
    "ssm": dict(name="tiny-ssm", family="ssm", n_layers=4, d_model=128,
                n_heads=0, n_kv_heads=0, d_ff=0, vocab=512, ssm_state=16,
                ssm_head_dim=16, ssm_expand=2, ssm_conv=4, ssm_chunk=16,
                norm_eps=1e-5, tie_embeddings=True),
}
TRAFFIC = {
    "prefill": {"driver": "prefill", "loop": "closed", "rows": 2,
                "prompt": [20, 60], "strata": 3, "max_len": 64},
    "generate": {"driver": "generate", "loop": "closed", "rows": 4,
                 "prompt": 24, "max_len": 48, "prefill_rows": 2,
                 "warm_steps": 2},
}
CELLS = {
    "olmoe-1b-7b.prefill-8x1k-4k": ("moe", "prefill"),
    "mamba2-370m.prefill-8x1k-4k": ("ssm", "prefill"),
    "olmoe-1b-7b.decode-64x4k": ("moe", "generate"),
}
LIMITS = json.loads((Path(__file__).parent / "tiny_limits.json").read_text())
# the MoE configuration's stated rules, which the reference reads
RULES = json.loads((Path(__file__).parents[1] / "configs/olmoe-1b-7b.json")
                   .read_text())["rules"]


def cell(workload: str, seed: int = 20261018, seconds: float = 0.0,
         program=None, root=None):
    """The workload's cell on the CPU at toy size, judged by the toy
    limits; a window of 0 seconds runs one batch or one step, so that the
    judged numbers do not hang on the host's speed."""
    from bench import harness

    fam, drv = CELLS[workload]
    kw = {"root": root} if root is not None else {}
    c = harness.Cell(workload, seed, seconds, device="cpu", program=program,
                     arch=ARCH[fam], traffic=TRAFFIC[drv], **kw)
    c.limits = {"numbers": {k: {"limit": v}
                            for k, v in LIMITS[workload].items()}}
    return c


def run(c, trace: bool = False) -> dict:
    from bench import harness

    return harness.run(c, trace, time.monotonic())

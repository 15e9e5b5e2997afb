"""Training corpus for the resource estimator (paper Sec 3.5.2).

The paper collected 831 samples by running PnR on Spatial's regression
suite.  No Vivado exists in this container, so labels come from a *synthetic
place-and-route emulator*: the structural proxy of core/resources.py plus
the deterministic nonlinear effects real PnR exhibits (LUT packing and
routing-pressure inflation for wide crossbars, retiming register
duplication proportional to datapath depth, carry-chain discounts, BRAM
quantization) and a small seeded lognormal noise.  This is stated openly in
EXPERIMENTS.md: the ML-pipeline comparison (GBT-vs-MLP, Fig. 11) is
reproduced against this synthetic PnR.

The JAX package has a second label source, ``hlo_label``, which counts the
compiled XLA scalar ops of each scheme's resolution graph.  It has no
counterpart here yet: it needs a stated substitute (for example the op
count of the scheme's kernel program), which comes with the multi-device
side of the port.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import problems
from .controller import Program
from .features import extract_features
from .planner import BankingPlanner
from .solver import BankingSolution, SolverOptions


# ---------------------------------------------------------------------------
# Synthetic PnR emulator
# ---------------------------------------------------------------------------


def _seed_from(x: np.ndarray) -> int:
    return int.from_bytes(hashlib.sha256(x.tobytes()).digest()[:4], "little")


def synthetic_pnr(sol: BankingSolution, noise: float = 0.05) -> Dict[str, float]:
    r = sol.resources
    feats = extract_features(sol)
    rng = np.random.default_rng(_seed_from(feats))

    lut = r.crossbar.lut + r.resolution.lut + r.storage.lut
    # routing-pressure inflation: wide crossbars pack badly
    if r.crossbar.lut > 400:
        lut += 0.35 * (r.crossbar.lut - 400)
    # carry-chain discount: adder trees pack into CARRY4 slices
    lut -= 0.2 * min(r.resolution.lut, 300)
    # control overhead per bank
    lut += 24 + 4.0 * sol.num_banks * sol.duplicates

    ff = r.total.ff
    # retiming duplicates registers along deep resolution pipelines
    depth_proxy = max(1.0, r.resolution.lut / 64.0)
    ff *= 1.0 + 0.08 * depth_proxy
    ff += 16 + 2.0 * sol.num_banks

    bram = float(r.total.bram)
    dsp = float(r.total.dsp)

    lut *= float(np.exp(rng.normal(0, noise)))
    ff *= float(np.exp(rng.normal(0, noise)))
    return {"lut": max(lut, 8.0), "ff": max(ff, 4.0), "bram": bram, "dsp": dsp}


# ---------------------------------------------------------------------------
# Corpus generation
# ---------------------------------------------------------------------------


def corpus_programs(seed: int = 0) -> List[Tuple[str, Program]]:
    """The benchmark suite plus randomized variants (sizes, pars, ports)."""
    rng = np.random.default_rng(seed)
    progs: List[Tuple[str, Program]] = []
    for name in problems.STENCILS:
        progs.append((name, problems.stencil_program(name)))
    progs.append(("sw", problems.sw_program()))
    progs.append(("spmv", problems.spmv_program()))
    progs.append(("sgd", problems.sgd_program()))
    progs.append(("md_grid", problems.md_grid_program()))
    # randomized variants
    for name in problems.STENCILS:
        for _ in range(2):
            H = int(rng.choice([64, 128, 256]))
            W = int(rng.choice([64, 128, 256]))
            par = int(rng.choice([1, 2, 4]))
            ports = int(rng.choice([1, 2]))
            progs.append(
                (f"{name}/H{H}W{W}p{par}k{ports}",
                 problems.stencil_program(name, H=H, W=W, par=par, ports=ports))
            )
    for _ in range(4):
        progs.append((f"sw/p{_}", problems.sw_program(
            H=int(rng.choice([32, 64])), W=int(rng.choice([32, 64])),
            par=int(rng.choice([2, 4, 8])))))
        progs.append((f"sgd/p{_}", problems.sgd_program(
            par_a=int(rng.choice([2, 4])), par_b=int(rng.choice([2, 3])))))
    return progs


@dataclass
class Dataset:
    X: np.ndarray
    y: Dict[str, np.ndarray]  # per-resource labels
    names: List[str]          # sample provenance


def build_dataset(seed: int = 0, opts: Optional[SolverOptions] = None,
                  max_per_program: int = 40) -> Dataset:
    opts = opts or SolverOptions(max_solutions=24, n_budget=24)
    planner = BankingPlanner(opts=opts)
    rows, names = [], []
    labels: Dict[str, List[float]] = {"lut": [], "ff": [], "bram": [], "dsp": []}
    for pname, prog in corpus_programs(seed):
        for memname in prog.memories:
            plan = planner.plan(prog, memname)
            for s in plan.solutions[:max_per_program]:
                rows.append(extract_features(s, plan.groups))
                lab = synthetic_pnr(s)
                for k in labels:
                    labels[k].append(lab[k])
                names.append(f"{pname}:{memname}")
    X = np.asarray(rows)
    y = {k: np.asarray(v) for k, v in labels.items()}
    return Dataset(X=X, y=y, names=names)

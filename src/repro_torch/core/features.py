"""Feature extraction for the ML resource estimator (paper Sec 3.5.1).

Two classes of raw features, as in Fig. 10:

* **Template features** -- primitives and derived parameters of the banking
  scheme itself (N, B, alpha, fan-out/fan-in, bank volume, op histogram of
  the transformed resolution graph, ...).
* **Subgraph features** -- neighbours/accessors of the memory node in the
  dataflow (#readers, #writers, group structure, iterator space, dims).

The first pipeline stage then takes degree-2 polynomial combinations of
these (e.g. the product of per-dimension bank counts), exactly as the paper
describes.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .solver import BankingSolution
from .transforms import Node

TEMPLATE_FEATURES = [
    "num_banks", "blocking", "alpha_max", "alpha_nnz", "bank_volume",
    "log_bank_volume", "fo_max", "fo_sum", "fo_mean", "fan_in_max",
    "required_ports", "duplicates", "pad_total", "word_bits",
    "n_add", "n_select", "n_shift", "n_mul_raw", "n_div_raw", "n_mod_raw",
    "graph_depth", "is_multidim",
]

SUBGRAPH_FEATURES = [
    "n_readers", "n_writers", "n_groups", "max_group", "n_dims",
    "mem_volume", "log_mem_volume", "n_accesses",
]

FEATURE_NAMES = TEMPLATE_FEATURES + SUBGRAPH_FEATURES


def _graph_histogram(node) -> Dict[str, int]:
    hist = {"add": 0, "sub": 0, "select": 0, "ge": 0, "shl": 0, "shr": 0,
            "and": 0, "mul": 0, "div": 0, "mod": 0}
    depth = 0
    seen = set()

    def walk(n: Node, d: int):
        nonlocal depth
        depth = max(depth, d)
        if id(n) in seen:
            return
        seen.add(id(n))
        if n.op in hist:
            hist[n.op] += 1
        for a in n.args:
            walk(a, d + 1)

    if node is not None:
        nodes = node if isinstance(node, tuple) else (node,)
        for nd in nodes:
            walk(nd, 0)
    hist["_depth"] = depth
    return hist


def extract_features(sol: BankingSolution, groups=None) -> np.ndarray:
    geo = sol.geometry
    if sol.kind == "flat":
        blocking = geo.B
        alpha = geo.alpha
        multidim = 0.0
    else:
        blocking = int(np.prod(geo.Bs))
        alpha = geo.alphas
        multidim = 1.0
    hist = _graph_histogram(sol.resolution_ba)
    hist_bo = _graph_histogram(sol.resolution_bo)
    for k in hist:
        if k != "_depth":
            hist[k] += hist_bo.get(k, 0)
    hist["_depth"] = max(hist["_depth"], hist_bo["_depth"])

    fos = np.asarray(sol.fan_outs or (1,), dtype=np.float64)
    groups = groups or []
    readers = writers = naccess = 0
    max_group = 0
    for g in groups:
        max_group = max(max_group, len(g))
        for a in g:
            naccess += 1
            if a.is_write:
                writers += 1
            else:
                readers += 1
    if naccess == 0:
        naccess = len(fos)
        readers = naccess

    tmpl = [
        sol.num_banks, blocking, max(abs(a) for a in alpha),
        sum(1 for a in alpha if a), sol.bank_volume,
        np.log1p(sol.bank_volume), fos.max(), fos.sum(), fos.mean(),
        sol.max_fan_in, sol.required_ports, sol.duplicates,
        sum(sol.pad), sol.memory.word_bits,
        hist["add"] + hist["sub"], hist["select"] + hist["ge"],
        hist["shl"] + hist["shr"] + hist["and"],
        hist["mul"], hist["div"], hist["mod"],
        hist["_depth"], multidim,
    ]
    sub = [
        readers, writers, max(1, len(groups)), max_group, sol.memory.n,
        sol.memory.volume, np.log1p(sol.memory.volume), naccess,
    ]
    return np.asarray(tmpl + sub, dtype=np.float64)


def poly2_expand(X: np.ndarray, names: Sequence[str] = FEATURE_NAMES
                 ) -> Tuple[np.ndarray, List[str]]:
    """Degree-2 polynomial combinations (paper: first pipeline stage)."""
    n, d = X.shape
    cols = [X]
    out_names = list(names)
    for i in range(d):
        for j in range(i, d):
            cols.append((X[:, i] * X[:, j])[:, None])
            out_names.append(f"{names[i]}*{names[j]}")
    return np.concatenate(cols, axis=1), out_names

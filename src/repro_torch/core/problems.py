"""Benchmark banking problems (paper Sec 4, Tables 2-3, Fig. 12).

Eight stencil patterns plus three real-world applications (Smith-Waterman
GACT, SpMV, minibatch SGD), each expressed as a controller-tree Program.
The paper's pattern glyphs are images; the point geometries below follow the
names and the paper's prose (denoise/bicubic are '4-point accesses', sobel is
the full 3x3, motion-* are line patterns, denoise-ur is the unrolled variant).

These drive (a) the Table 2/3 comparisons and (b) the training corpus for
the ML resource estimator (Sec 3.5.2 uses Spatial's regression suite; our
corpus is this suite plus randomized variants -- see core/dataset.py).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .controller import AccessDecl, Counter, Ctrl, Program, Sched
from .polytope import Affine, MemorySpec

# ---------------------------------------------------------------------------
# Stencils: image SRAM of shape (H, W); row loop r, column loop c (par P).
# One access per pattern point at (r+dr, c+dc); vectorization by P adds
# lane offsets on c.  Ports=2 (true-dual-ported BRAM18).
# ---------------------------------------------------------------------------

STENCIL_POINTS: Dict[str, List[Tuple[int, int]]] = {
    "denoise":   [(0, 0), (-1, 0), (1, 0), (0, -1)],          # 4-point
    "deconv":    [(0, 0), (0, -1), (0, -2), (-1, 0), (-2, 0)],
    "denoise-ur": [(0, 0), (-1, 0), (1, 0), (0, -1)],          # + par 2
    "bicubic":   [(0, 0), (0, 1), (1, 0), (1, 1)],             # 4-point
    "sobel":     [(dr, dc) for dr in (-1, 0, 1) for dc in (-1, 0, 1)],
    "motion-lv": [(-1, 0), (0, 0), (1, 0)],
    "motion-lh": [(0, -2), (0, -1), (0, 0), (0, 1), (0, 2)],
    "motion-c":  [(0, 0), (0, 1), (1, 0), (1, 1)],
}

STENCIL_PAR: Dict[str, int] = {
    "denoise": 1, "deconv": 1, "denoise-ur": 2, "bicubic": 1, "sobel": 1,
    "motion-lv": 2, "motion-lh": 2, "motion-c": 1,
}


def stencil_program(name: str, H: int = None, W: int = 128,
                    par: int = None, ports: int = 2) -> Program:
    """Line-buffer stencil: the on-chip memory holds only the bbox rows of
    the pattern (row rotation abstracted away, as Spatial's LineBuffer
    does), so dim-0 indices are pattern constants and dim-1 slides with c."""
    pts = STENCIL_POINTS[name]
    P = STENCIL_PAR[name] if par is None else par
    rows = [dr for dr, _ in pts]
    cols = [dc for _, dc in pts]
    r0, c0 = min(rows), min(cols)
    n_rows = max(rows) - r0 + 1 if H is None else H
    mem = MemorySpec("img", dims=(n_rows, W), word_bits=16, ports=ports)
    accesses = [
        AccessDecl(
            "img",
            (Affine.const_(dr - r0), Affine.of(const=dc - c0, c=1)),
            label=f"{name}[{dr},{dc}]",
        )
        for dr, dc in pts
    ]
    span = max(cols) - c0
    inner = Ctrl(
        "cols", Sched.INNER,
        counters=[Counter("c", 0, 1, W - span, par=P)],
        accesses=accesses,
    )
    root = Ctrl(
        "rows", Sched.PIPELINED,
        counters=[Counter("r", 0, 1, 128)],
        children=[inner],
    )
    return Program(root=root, memories={"img": mem})


# ---------------------------------------------------------------------------
# Smith-Waterman (GACT): wavefront DP, cell (i,j) reads N/W/NW, par 4 on the
# anti-diagonal (Fig. 12a).
# ---------------------------------------------------------------------------


def sw_program(H: int = 64, W: int = 64, par: int = 4, ports: int = 2) -> Program:
    mem = MemorySpec("tile", dims=(H, W), word_bits=16, ports=ports)
    # wavefront: lanes advance along the anti-diagonal; lane l handles row
    # i*par+l, column j-l => accesses are skewed reads + one write.
    accesses = []
    for (dr, dc, w, tag) in [(-1, 0, False, "n"), (0, -1, False, "w"),
                             (-1, -1, False, "nw"), (0, 0, True, "self")]:
        accesses.append(
            AccessDecl(
                "tile",
                (Affine.of(const=dr + 1, i=1), Affine.of(const=dc + 1, j=1, i=-1)),
                is_write=w, label=f"sw.{tag}",
            )
        )
    inner = Ctrl(
        "cell", Sched.INNER,
        counters=[Counter("i", 0, 1, H - 1, par=par)],
        accesses=accesses,
    )
    root = Ctrl(
        "diag", Sched.PIPELINED,
        counters=[Counter("j", 0, 1, W - 1)],
        children=[inner],
    )
    return Program(root=root, memories={"tile": mem})


# ---------------------------------------------------------------------------
# SpMV: edge-list over dense regions; par 4 rows x 3 cols; each row's strided
# pattern has a data-dependent ('random') column offset (Fig. 12b) -- modelled
# with an uninterpreted per-row symbol.  Projection regrouping makes the
# offset disappear on the row dimension (paper Sec 4, 'good candidate for
# multidimensional banking').
# ---------------------------------------------------------------------------


def spmv_program(R: int = 64, C: int = 64, par_r: int = 4, par_c: int = 3,
                 ports: int = 2) -> Program:
    mem = MemorySpec("mat", dims=(R, C), word_bits=32, ports=ports)
    col = Affine.of(c=1)
    accesses = [
        AccessDecl("mat", (Affine.of(r=1), col), label="spmv.rd"),
    ]
    inner = Ctrl(
        "cols", Sched.INNER,
        counters=[
            Counter("c", 0, 1, None, par=par_c, start_sym="row_off"),
        ],
        accesses=accesses,
    )
    rows = Ctrl(
        "rows", Sched.FORKJOIN,
        counters=[Counter("r", 0, 1, R, par=par_r)],
        children=[inner],
    )
    return Program(root=rows, memories={"mat": mem})


# ---------------------------------------------------------------------------
# Minibatch SGD: on-chip (R, C) data matrix, two never-concurrent access
# modes (two groups): column-major predict reads and row-major gradient
# reads, each 12-wide (Fig. 12c).
# ---------------------------------------------------------------------------


def sgd_program(R: int = 48, C: int = 48, par_a: int = 4, par_b: int = 3,
                ports: int = 2) -> Program:
    mem = MemorySpec("data", dims=(R, C), word_bits=32, ports=ports)
    predict = Ctrl(
        "predict", Sched.INNER,
        counters=[
            Counter("pi", 0, 1, R, par=par_a),
            Counter("pj", 0, 1, C, par=par_b),
        ],
        accesses=[AccessDecl("data", (Affine.of(pi=1), Affine.of(pj=1)),
                             label="sgd.predict")],
    )
    grad = Ctrl(
        "grad", Sched.INNER,
        counters=[
            Counter("gi", 0, 1, R, par=par_b),
            Counter("gj", 0, 1, C, par=par_a),
        ],
        accesses=[AccessDecl("data", (Affine.of(gi=1), Affine.of(gj=1)),
                             label="sgd.grad")],
    )
    root = Ctrl("epoch", Sched.SEQUENTIAL,
                counters=[Counter("e", 0, 1, 8)],
                children=[predict, grad])
    return Program(root=root, memories={"data": mem})


# ---------------------------------------------------------------------------
# MD-grid running example (Fig. 7/9): 4-D dvec_sram with PL-wide writes and
# PX*PY*PZ*PQ readers whose q loop has data-dependent bounds.
# ---------------------------------------------------------------------------


def md_grid_program(W: int = 4, Nmax: int = 8, PL: int = 2, PX: int = 2,
                    PY: int = 1, PZ: int = 1, PQ: int = 2,
                    ports: int = 2) -> Program:
    mem = MemorySpec("dvec", dims=(W, W, W, Nmax), word_bits=32, ports=ports)
    writer = Ctrl(
        "load", Sched.INNER,
        counters=[
            Counter("d0", 0, 1, W), Counter("d1", 0, 1, W),
            Counter("d2", 0, 1, W), Counter("d3", 0, 1, Nmax, par=PL),
        ],
        accesses=[AccessDecl(
            "dvec",
            (Affine.of(d0=1), Affine.of(d1=1), Affine.of(d2=1), Affine.of(d3=1)),
            is_write=True, label="md.wr")],
    )
    reader = Ctrl(
        "compute", Sched.INNER,
        counters=[
            Counter("x", 0, 1, W, par=PX), Counter("y", 0, 1, W, par=PY),
            Counter("z", 0, 1, W, par=PZ),
            Counter("q", 0, 1, None, par=PQ),  # Q_RNG(x,y,z): data-dependent
        ],
        accesses=[AccessDecl(
            "dvec",
            (Affine.of(x=1), Affine.of(y=1), Affine.of(z=1), Affine.of(q=1)),
            label="md.rd")],
    )
    root = Ctrl("main", Sched.SEQUENTIAL,
                counters=[Counter("t", 0, 1, 4)],
                children=[writer, reader])
    return Program(root=root, memories={"dvec": mem})


STENCILS = list(STENCIL_POINTS)
APPS = ["sw", "spmv", "sgd"]


def build(name: str, **kw) -> Program:
    if name in STENCIL_POINTS:
        return stencil_program(name, **kw)
    if name == "sw":
        return sw_program(**kw)
    if name == "spmv":
        return spmv_program(**kw)
    if name == "sgd":
        return sgd_program(**kw)
    if name == "md_grid":
        return md_grid_program(**kw)
    raise KeyError(name)

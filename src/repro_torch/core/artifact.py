"""CompiledBankingPlan: the executable artifact a plan lowers to.

The paper's deliverable is not the partitioning *scheme* but the
**resolution circuit** it generates -- the BA/BO arithmetic (Eq. 1-2,
strength-reduced per Sec 3.4) placed in front of the memory.
``compile_solution`` / ``compile_geometry`` / ``compile_trivial`` produce a
durable :class:`CompiledBankingPlan` that owns everything execution needs:

* the **physical layout** (bank count, bank volume, padding, bank-major
  table shape) as a :class:`BankingLayout`;
* **ba/bo callables** lowered once from the transform graphs (torch tensor
  ops on the ``torch`` backend, numpy on the ``numpy`` backend), and the
  same graphs flattened into the **kernel program** the CUDA kernels
  interpret (:meth:`CompiledBankingPlan.kernel_program`);
* ``pack`` / ``unpack`` between logical row-major tensors and bank-major
  storage (reference Eq. 1-2 arithmetic, vectorized torch indexing);
* ``gather(table, rows)`` binding the banked-gather CUDA kernel, which
  runs the compiled resolution arithmetic per row in front of the load;
* ``scatter(table, rows, values)`` -- the write path through the same
  circuit (full rows, or single columns for per-slot record writes),
  **in place** on the given table.

On a CUDA table ``gather``/``scatter`` launch the kernels or raise; on a
CPU table they take the plain torch versions in
``kernels/banked_gather.py``.  Artifacts serialize to JSON (including the
op graphs, DAG-preserving) in the same ``compiled-banking-plan/v1`` format
as the JAX package writes, identical apart from the ``backend`` field, so
a file saved by either package loads in the other.  ``compile_plan``
lowers a planner's chosen scheme and ``lane_compile`` the first scheme
fit for device-lane banking, whose ``to_partition_spec`` places the
banked dim on a mesh axis (``parallel/sharding.py``).
"""

from __future__ import annotations

import json
import time
import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .geometry import FlatGeometry, MultiDimGeometry
from .polytope import MemorySpec
from .solver import BankingSolution, _flat_in_bits
from .transforms import (
    KernelProgram,
    Node,
    build_flat_resolution,
    build_multidim_resolution,
    lower_kernel_program,
    lower_np,
    lower_torch,
)

FORMAT = "compiled-banking-plan/v1"

BACKENDS = ("torch", "numpy")


# ---------------------------------------------------------------------------
# Op-graph (Node DAG) serialization -- shared subexpressions stay shared
# ---------------------------------------------------------------------------


def graph_to_json(roots: Sequence[Node]) -> dict:
    """Serialize Node DAGs as a topo-ordered node list + root indices."""
    order: List[Node] = []
    index: Dict[int, int] = {}

    def visit(n: Node) -> int:
        key = id(n)
        if key in index:
            return index[key]
        arg_ids = [visit(a) for a in n.args]
        index[key] = len(order)
        order.append(n)
        # stash resolved arg indices alongside (parallel list below)
        arg_lists.append(arg_ids)
        return index[key]

    arg_lists: List[List[int]] = []
    root_ids = [visit(r) for r in roots]
    nodes = [
        {"op": n.op, "args": args, "value": n.value, "name": n.name,
         "width": n.width}
        for n, args in zip(order, arg_lists)
    ]
    return {"nodes": nodes, "roots": root_ids}


def graph_from_json(d: dict) -> List[Node]:
    built: List[Node] = []
    for nd in d["nodes"]:
        args = tuple(built[i] for i in nd["args"])
        built.append(Node(op=nd["op"], args=args, value=nd["value"],
                          name=nd["name"], width=nd["width"]))
    return [built[i] for i in d["roots"]]


# ---------------------------------------------------------------------------
# Physical layout
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BankingLayout:
    """The physical shape a compiled plan stores data in.

    Logical ``dims`` (row-major addressing) map onto ``n_banks`` banks of
    ``bank_volume`` rows each; ``pad`` is the per-dimension padding the
    partition parallelotope requires (padded slots exist in the bank-major
    table but hold no logical row).
    """

    dims: Tuple[int, ...]
    pad: Tuple[int, ...]
    n_banks: int
    bank_volume: int

    @property
    def padded_dims(self) -> Tuple[int, ...]:
        return tuple(d + p for d, p in zip(self.dims, self.pad))

    @property
    def logical_size(self) -> int:
        return int(np.prod(self.dims))

    def table_shape(self, row_width: int) -> Tuple[int, int, int]:
        """Bank-major storage shape for rows of ``row_width`` elements."""
        return (self.n_banks, self.bank_volume, row_width)


# ---------------------------------------------------------------------------
# The compiled artifact
# ---------------------------------------------------------------------------


class CompiledBankingPlan:
    """Executable lowering of one banking plan (see module docstring).

    Construct via :func:`compile_solution` / :func:`compile_geometry` /
    :func:`compile_trivial` -- not directly.
    """

    def __init__(self, *, memory: str, signature: str, backend: str,
                 kind: str, geometry, P: Tuple[int, ...],
                 layout: BankingLayout,
                 ba_graphs: Tuple[Node, ...], bo_graph: Node,
                 fan_outs: Tuple[int, ...] = (), max_fan_in: int = 1,
                 required_ports: int = 1, duplicates: int = 1,
                 scorer_name: str = "", note: str = ""):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
        self.memory = memory
        self.signature = signature
        self.backend = backend
        self.kind = kind
        self.geometry = geometry
        self.P = tuple(P)
        self.layout = layout
        self.ba_graphs = tuple(ba_graphs)
        self.bo_graph = bo_graph
        self.fan_outs = tuple(fan_outs)
        self.max_fan_in = max_fan_in
        self.required_ports = required_ports
        self.duplicates = duplicates
        self.scorer_name = scorer_name
        self.note = note
        self._tables_cache: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._device_tables: Dict[str, tuple] = {}   # pack/unpack indices
        self._kernel_program: Optional[KernelProgram] = None
        self._telemetry = None   # opt-in timing sink (see enable_telemetry)
        self._lower()

    # -- lowering ----------------------------------------------------------
    def _lower(self) -> None:
        lower = lower_torch if self.backend == "torch" else lower_np
        ba_fns = [lower(g) for g in self.ba_graphs]
        bo_fn = lower(self.bo_graph)
        if self.kind == "multidim":
            Ns = self.geometry.Ns

            def ba(*xs):
                env = {f"x{i}": x for i, x in enumerate(xs)}
                out = None
                for f, n in zip(ba_fns, Ns):
                    b = f(**env)
                    out = b if out is None else out * n + b
                return out
        else:
            f0 = ba_fns[0]

            def ba(*xs):
                return f0(**{f"x{i}": x for i, x in enumerate(xs)})

        def bo(*xs):
            return bo_fn(**{f"x{i}": x for i, x in enumerate(xs)})

        self.ba = ba   # bank address from logical coordinates x0..x{n-1}
        self.bo = bo   # intra-bank offset from logical coordinates

    def kernel_program(self) -> KernelProgram:
        """The BA graphs and the BO graph as one register program: what the
        CUDA kernels evaluate per row in front of the memory (lowered once,
        then cached).  Raises when the circuit exceeds the kernels'
        capacities; it is never truncated."""
        if self._kernel_program is None:
            self._kernel_program = lower_kernel_program(
                self.ba_graphs, self.bo_graph, len(self.layout.dims))
        return self._kernel_program

    # -- convenience metadata ----------------------------------------------
    @property
    def n_banks(self) -> int:
        return self.layout.n_banks

    @property
    def bank_volume(self) -> int:
        return self.layout.bank_volume

    @property
    def max_fan_out(self) -> int:
        return max(self.fan_outs) if self.fan_outs else 1

    def describe(self) -> str:
        g = self.geometry
        if self.kind == "flat":
            head = f"compiled flat N={g.N} B={g.B} alpha={g.alpha} P={self.P}"
        else:
            head = f"compiled multidim N={g.Ns} B={g.Bs} alpha={g.alphas}"
        return (f"{head} banks={self.n_banks} vol={self.bank_volume} "
                f"FOmax={self.max_fan_out} backend={self.backend}")

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<CompiledBankingPlan {self.describe()}>"

    # -- address resolution ------------------------------------------------
    def _split(self, addr):
        """Flat row-major logical address -> per-dimension coordinates."""
        dims = self.layout.dims
        if len(dims) == 1:
            return (addr,)
        strides = []
        s = 1
        for d in reversed(dims):
            strides.append(s)
            s *= d
        strides = strides[::-1]
        return tuple((addr // st) % d for st, d in zip(strides, dims))

    def resolve(self, addr):
        """(bank, offset) of a flat logical address (scalar or array).

        This is the Eq. 1-2 resolution circuit, lowered through the Sec-3.4
        transforms -- the same graphs the CUDA kernels interpret, here as
        array ops.  On the ``torch`` backend ``addr`` is an integer tensor
        and both results are tensors of its shape, dtype and device.
        """
        xs = self._split(addr)
        ba, bo = self.ba(*xs), self.bo(*xs)
        if self.backend == "torch":
            import torch

            def full(v):   # a graph without inputs lowers to a Python int
                if isinstance(v, torch.Tensor):
                    return v.expand(addr.shape)
                return torch.full_like(addr, int(v))

            return full(ba), full(bo)
        return ba, bo

    # -- layout conversion -------------------------------------------------
    def _tables(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-address (bank, offset) tables from the *reference* (raw
        Eq. 1-2) arithmetic -- tests assert the transformed circuit agrees
        with this layout, so pack must not use the transformed graphs."""
        if self._tables_cache is not None:
            return self._tables_cache
        dims = self.layout.dims
        addr = np.arange(self.layout.logical_size, dtype=np.int64)
        xs = self._split(addr)
        g = self.geometry
        if self.kind == "flat":
            y = np.zeros_like(addr)
            for x, a in zip(xs, g.alpha):
                y = y + x * a
            ba = (y // g.B) % g.N
            acc = np.zeros_like(addr)
            for i in range(len(dims)):
                stride = 1
                for j in range(i + 1, len(dims)):
                    stride *= -(-dims[j] // self.P[j])
                acc = acc + (xs[i] // self.P[i]) * stride
            bo = g.B * acc + y % g.B
        else:
            ba = None
            bo = np.zeros_like(addr)
            for x, a, b, n, d in zip(xs, g.alphas, g.Bs, g.Ns, dims):
                y = x * a
                ba_d = (y // b) % n
                ba = ba_d if ba is None else ba * n + ba_d
                blocks = -(-d * a // b)
                per_bank = -(-blocks // n)
                coord = (y // (b * n)) * b + y % b
                bo = bo * (per_bank * b) + coord
        self._tables_cache = (ba.astype(np.int64), bo.astype(np.int64))
        return self._tables_cache

    def _index_tables(self, device):
        """The reference (bank, offset) tables as int64 tensors on
        ``device``, copied there once."""
        import torch

        key = str(device)
        if key not in self._device_tables:
            ba, bo = self._tables()
            self._device_tables[key] = (torch.from_numpy(ba).to(device),
                                        torch.from_numpy(bo).to(device))
        return self._device_tables[key]

    def pack(self, flat, device=None):
        """Logical (A, D) rows -> bank-major (n_banks, bank_volume, D).

        Rows land where the layout's reference BA/BO equations place them;
        padded slots stay zero.  ``A`` must equal the logical size.  The
        table is built on ``device``; the default is the device ``flat``
        lies on when it is a tensor, else ``cuda``, which raises when there
        is no card (pass ``device="cpu"`` for a host table).
        """
        import torch

        from ..device import resolve_device

        if device is None:
            device = flat.device if isinstance(flat, torch.Tensor) else "cuda"
        flat = torch.as_tensor(flat).to(resolve_device(device))
        A, D = flat.shape
        if A != self.layout.logical_size:
            raise ValueError(
                f"pack expects {self.layout.logical_size} logical rows "
                f"(dims={self.layout.dims}), got {A}")
        ba, bo = self._index_tables(flat.device)
        table = torch.zeros(self.layout.table_shape(D), dtype=flat.dtype,
                            device=flat.device)
        table[ba, bo] = flat
        return table

    def unpack(self, table):
        """Bank-major (n_banks, bank_volume, D) -> logical (A, D) rows.

        Exact inverse of :meth:`pack`: padding slots are dropped, so
        ``unpack(pack(x)) == x``.
        """
        if tuple(table.shape[:2]) != (self.n_banks, self.bank_volume):
            raise ValueError(
                f"table shape {tuple(table.shape)} does not match layout "
                f"{self.layout.table_shape(-1)[:2]}")
        ba, bo = self._index_tables(table.device)
        return table[ba, bo]

    # -- telemetry hooks ---------------------------------------------------
    def enable_telemetry(self, sink) -> None:
        """Attach a timing sink: every gather/scatter call is wall-timed
        (after ``torch.cuda.synchronize()`` when the result lies on a card,
        so the time is the kernel's and not the enqueue's) and reported as
        ``sink.observe(self, op, index_shape, seconds)``.  The sink is
        duck-typed.  With no sink attached (the default) the execution
        paths are untouched and nothing synchronizes.
        """
        self._telemetry = sink

    def disable_telemetry(self) -> None:
        self._telemetry = None

    def _timed(self, op: str, rows, fn):
        sink = self._telemetry
        if sink is None:
            return fn()
        t0 = time.perf_counter()
        out = fn()
        if getattr(out, "is_cuda", False):
            import torch

            torch.cuda.synchronize(out.device)   # launches are asynchronous
        sink.observe(self, op, tuple(np.shape(rows)),
                     time.perf_counter() - t0)
        return out

    # -- execution ---------------------------------------------------------
    def gather(self, table, rows):
        """Gather logical rows from bank-major storage.  With a telemetry
        sink attached (:meth:`enable_telemetry`) the call is wall-timed
        and the latency logged under this artifact's scheme."""
        return self._timed("gather", rows, lambda: self._gather(table, rows))

    def scatter(self, table, rows, values, *, col=None):
        """Write logical rows into bank-major storage (see
        :meth:`_scatter`); wall-timed when a telemetry sink is attached."""
        return self._timed("scatter", rows,
                           lambda: self._scatter(table, rows, values,
                                                 col=col))

    def _gather(self, table, rows):
        """Gather logical rows from bank-major storage.

        ``rows`` is a ``(T,)`` vector of flat logical addresses -- or a
        stacked ``(T, R)`` matrix of T row-sets (e.g. one decode tick's
        reads for every active sequence), which issues ONE kernel launch
        for the whole batch and returns ``(T, R, D)`` instead of T
        per-row-set calls.

        ``torch`` backend: on a CUDA table the banked-gather kernel, which
        evaluates :meth:`kernel_program` per row in front of the load (a
        failed build or launch raises; nothing falls back); on a CPU table
        its plain torch version.  ``numpy`` backend: direct advanced
        indexing through the numpy-lowered resolution callables.
        """
        if self.backend == "numpy":
            # resolution callables are shape-preserving: (T,) and (T, R)
            # index arrays both work through one advanced-indexing gather
            ba, bo = self.resolve(np.asarray(rows, dtype=np.int64))
            return np.asarray(table)[ba, bo]
        from ..kernels.banked_gather import as_index, banked_gather

        rows = as_index(rows, getattr(table, "device", "cpu"),
                        self.layout.logical_size)
        if rows.ndim == 2:
            # stacked row-sets: flatten into a single launch, then restore
            # the (T, R) structure
            T, R = rows.shape
            flat = banked_gather(table, rows.reshape(T * R), self)
            return flat.reshape(T, R, flat.shape[-1])
        return banked_gather(table, rows, self)

    def _scatter(self, table, rows, values, *, col=None):
        """Write logical rows into bank-major storage -- the write-path
        analogue of :meth:`gather`.

        ``rows`` is a ``(T,)`` vector of flat logical addresses.  With
        ``col=None``, ``values`` is a ``(T, D)`` matrix of replacement
        rows; with ``col`` a ``(T,)`` vector of column indices,
        ``values`` is a ``(T,)`` vector of scalars written at
        ``table[ba, bo, col]`` -- one kernel launch for a whole batch of
        per-slot token-record writes, no read-modify-write.  Duplicates
        resolve last-write-wins in index order.

        ``torch`` backend: the table is updated **in place** and returned
        (the numpy backend, like the JAX package, returns an updated
        copy).  On a CUDA table the banked-scatter kernels run the BA/BO
        program in front of the store and settle duplicates on the device;
        on a CPU table their plain torch versions do.
        """
        if self.backend == "numpy":
            ba, bo = self.resolve(np.asarray(rows, dtype=np.int64))
            out = np.array(table, copy=True)
            if col is None:
                out[ba, bo] = values
            else:
                out[ba, bo, np.asarray(col, dtype=np.int64)] = values
            return out
        from ..kernels.banked_gather import (banked_scatter,
                                             banked_scatter_elems)

        if col is None:
            return banked_scatter(table, rows, values, self)
        return banked_scatter_elems(table, rows, col, values, self)

    # -- device-level banking ----------------------------------------------
    def banked_dims(self) -> Tuple[int, ...]:
        """Logical dimensions this scheme actually splits across banks."""
        if self.kind == "multidim":
            return tuple(d for d, n in enumerate(self.geometry.Ns) if n > 1)
        if self.n_banks <= 1:
            return ()
        nz = tuple(d for d, a in enumerate(self.geometry.alpha) if a != 0)
        return nz

    def to_partition_spec(self, mesh_axes):
        """Map the banked dimensions onto mesh axes as a ``PartitionSpec``
        (``parallel.sharding.PartitionSpec``: one entry per logical dim).

        ``mesh_axes``: one axis name (or a tuple of names, sharded jointly)
        for a scheme banking a single dimension, or a sequence with one
        entry per banked dimension for multidimensional schemes.  Raises
        ``ValueError`` for geometries with no orthogonal device analogue
        (diagonal hyperplanes touch every dim at once -- there is no mesh
        axis assignment that reproduces them).
        """
        from ..parallel.sharding import PartitionSpec

        nd = len(self.layout.dims)
        banked = self.banked_dims()
        spec: List[object] = [None] * nd
        if not banked:
            return PartitionSpec(*spec)
        if self.kind == "flat":
            if len(banked) > 1:
                raise ValueError(
                    f"flat scheme with diagonal alpha={self.geometry.alpha} "
                    f"has no orthogonal PartitionSpec")
            spec[banked[0]] = mesh_axes  # str or tuple both legal entries
            return PartitionSpec(*spec)
        axes = ([mesh_axes] if isinstance(mesh_axes, str) else
                list(mesh_axes))
        if len(axes) != len(banked):
            raise ValueError(
                f"scheme banks dims {banked} but got {len(axes)} mesh "
                f"axes ({axes})")
        for d, ax in zip(banked, axes):
            spec[d] = ax
        return PartitionSpec(*spec)

    # -- serialization -----------------------------------------------------
    def to_json(self) -> dict:
        g = self.geometry
        if self.kind == "flat":
            geo = {"N": g.N, "B": g.B, "alpha": list(g.alpha),
                   "P": list(g.P)}
        else:
            geo = {"Ns": list(g.Ns), "Bs": list(g.Bs),
                   "alphas": list(g.alphas)}
        return {
            "format": FORMAT,
            "memory": self.memory,
            "signature": self.signature,
            "backend": self.backend,
            "kind": self.kind,
            "geometry": geo,
            "P": list(self.P),
            "layout": {
                "dims": list(self.layout.dims),
                "pad": list(self.layout.pad),
                "n_banks": self.layout.n_banks,
                "bank_volume": self.layout.bank_volume,
            },
            "graphs": graph_to_json(list(self.ba_graphs) + [self.bo_graph]),
            "fan_outs": list(self.fan_outs),
            "max_fan_in": self.max_fan_in,
            "required_ports": self.required_ports,
            "duplicates": self.duplicates,
            "scorer_name": self.scorer_name,
            "note": self.note,
        }

    @staticmethod
    def from_json(d: dict, backend: Optional[str] = None
                  ) -> "CompiledBankingPlan":
        """Rebuild an artifact from its JSON form.  A file written by the
        JAX package names a backend this package does not have; it loads
        on the ``torch`` backend unless ``backend`` says otherwise."""
        if d.get("format") != FORMAT:
            raise ValueError(
                f"not a compiled banking plan: format={d.get('format')!r}")
        gd = d["geometry"]
        if d["kind"] == "flat":
            geo = FlatGeometry(N=gd["N"], B=gd["B"],
                               alpha=tuple(gd["alpha"]),
                               P=tuple(gd["P"]))
        else:
            geo = MultiDimGeometry(Ns=tuple(gd["Ns"]), Bs=tuple(gd["Bs"]),
                                   alphas=tuple(gd["alphas"]))
        ld = d["layout"]
        layout = BankingLayout(dims=tuple(ld["dims"]), pad=tuple(ld["pad"]),
                               n_banks=ld["n_banks"],
                               bank_volume=ld["bank_volume"])
        graphs = graph_from_json(d["graphs"])
        if backend is None:
            backend = d["backend"] if d["backend"] in BACKENDS else "torch"
        return CompiledBankingPlan(
            memory=d["memory"], signature=d["signature"],
            backend=backend, kind=d["kind"], geometry=geo,
            P=tuple(d["P"]), layout=layout,
            ba_graphs=tuple(graphs[:-1]), bo_graph=graphs[-1],
            fan_outs=tuple(d.get("fan_outs", ())),
            max_fan_in=d.get("max_fan_in", 1),
            required_ports=d.get("required_ports", 1),
            duplicates=d.get("duplicates", 1),
            scorer_name=d.get("scorer_name", ""),
            note=d.get("note", ""),
        )

    def save(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(path.suffix + ".tmp")
        tmp.write_text(json.dumps(self.to_json(), indent=1, sort_keys=True))
        tmp.replace(path)
        return path

    @staticmethod
    def load(path, backend: Optional[str] = None) -> "CompiledBankingPlan":
        return CompiledBankingPlan.from_json(
            json.loads(Path(path).read_text()), backend=backend)


# ---------------------------------------------------------------------------
# Compilation entry points
# ---------------------------------------------------------------------------


def compile_solution(sol: BankingSolution, *, signature: str = "",
                     backend: str = "torch", scorer_name: str = ""
                     ) -> CompiledBankingPlan:
    """Lower one BankingSolution into an executable artifact.

    Reuses the solution's Sec-3.4 resolution graphs when present (the
    solver attaches them); rebuilds them from the geometry otherwise.
    """
    mem = sol.memory
    if sol.kind == "flat":
        g = sol.geometry
        if sol.resolution_ba is not None and sol.resolution_bo is not None:
            ba_graphs: Tuple[Node, ...] = (sol.resolution_ba,)
            bo = sol.resolution_bo
        else:
            in_bits = _flat_in_bits(mem, g.alpha)
            ba, bo = build_flat_resolution(g.N, g.B, g.alpha, sol.P,
                                           mem.dims, in_bits)
            ba_graphs = (ba,)
    else:
        g = sol.geometry
        if sol.resolution_ba is not None and sol.resolution_bo is not None:
            ba_graphs = tuple(sol.resolution_ba)
            bo = sol.resolution_bo
        else:
            in_bits = max(_flat_in_bits(mem, g.alphas), 8)
            bas, bo = build_multidim_resolution(g.Ns, g.Bs, g.alphas,
                                                mem.dims, in_bits)
            ba_graphs = tuple(bas)
    layout = BankingLayout(dims=tuple(mem.dims), pad=tuple(sol.pad),
                           n_banks=sol.num_banks,
                           bank_volume=sol.bank_volume)
    return CompiledBankingPlan(
        memory=mem.name, signature=signature, backend=backend,
        kind=sol.kind, geometry=sol.geometry, P=tuple(sol.P), layout=layout,
        ba_graphs=ba_graphs, bo_graph=bo, fan_outs=tuple(sol.fan_outs),
        max_fan_in=sol.max_fan_in, required_ports=sol.required_ports,
        duplicates=sol.duplicates, scorer_name=scorer_name, note=sol.note)


def compile_plan(plan, *, backend: str = "torch") -> CompiledBankingPlan:
    """Lower a BankingPlan's chosen scheme.  Prefer ``plan.compile()`` /
    ``BankingPlanner.compile(plan)``, which cache and persist artifacts."""
    if plan.best is None:
        raise ValueError(
            f"plan for {plan.memory!r} has no solution to compile "
            f"(status={plan.status})")
    return compile_solution(plan.best, signature=plan.signature,
                            backend=backend, scorer_name=plan.scorer_name)


def compile_geometry(mem: MemorySpec, geometry, *,
                     P: Optional[Tuple[int, ...]] = None,
                     backend: str = "torch", transform_level: str = "full",
                     signature: str = "") -> CompiledBankingPlan:
    """Lower a bare geometry (test/tooling entry: no solver run needed)."""
    from .geometry import padding as geom_padding

    if isinstance(geometry, FlatGeometry):
        P = tuple(P if P is not None else geometry.P)
        in_bits = _flat_in_bits(mem, geometry.alpha)
        ba, bo = build_flat_resolution(geometry.N, geometry.B,
                                       geometry.alpha, P, mem.dims, in_bits,
                                       level=transform_level)
        ba_graphs: Tuple[Node, ...] = (ba,)
        kind = "flat"
        n_banks = geometry.N
    else:
        P = tuple(P if P is not None else
                  (max(1, -(-d // n))
                   for d, n in zip(mem.dims, geometry.Ns)))
        in_bits = max(_flat_in_bits(mem, geometry.alphas), 8)
        bas, bo = build_multidim_resolution(geometry.Ns, geometry.Bs,
                                            geometry.alphas, mem.dims,
                                            in_bits, level=transform_level)
        ba_graphs = tuple(bas)
        kind = "multidim"
        n_banks = geometry.num_banks
    layout = BankingLayout(dims=tuple(mem.dims),
                           pad=geom_padding(mem, P), n_banks=n_banks,
                           bank_volume=geometry.bank_volume(mem.dims))
    return CompiledBankingPlan(
        memory=mem.name, signature=signature, backend=backend, kind=kind,
        geometry=geometry, P=P, layout=layout, ba_graphs=ba_graphs,
        bo_graph=bo)


def compile_trivial(mem: MemorySpec, *, backend: str = "torch",
                    signature: str = "") -> CompiledBankingPlan:
    """The zero-solve fallback artifact: one bank, row-major offsets.

    ``FlatGeometry(N=1, B=1)`` with a unit parallelotope places every
    logical row at ``(bank 0, offset = flat address)`` -- always valid
    (it just serializes concurrent accesses), needs no solver or search,
    and compiles in microseconds, so a consumer can pack/gather
    *immediately* and hot-swap to the solved artifact when a solve lands.
    """
    nd = len(mem.dims)
    alpha = tuple(1 if i == 0 else 0 for i in range(nd))
    geo = FlatGeometry(N=1, B=1, alpha=alpha, P=(1,) * nd)
    art = compile_geometry(mem, geo, P=(1,) * nd, backend=backend,
                           signature=signature)
    art.note = "trivial single-bank fallback"
    return art


def lane_compile(plan, lanes: int, *, backend: str = "torch"
                 ) -> Optional[CompiledBankingPlan]:
    """Compile the first candidate suitable for device-lane banking.

    Device-level banking (the sharding bridge) needs a *flat* scheme whose
    bank count is a lane multiple with fan-out 1 -- each lane owns one
    shard, so no crossbar = no collective on the access path.  Returns the
    compiled artifact, or None when no candidate qualifies.
    """
    for s in plan.solutions:
        if (s.kind == "flat" and lanes > 0 and s.num_banks % lanes == 0
                and s.fan_outs and max(s.fan_outs) == 1):
            return compile_solution(s, signature=plan.signature,
                                    backend=backend,
                                    scorer_name=plan.scorer_name)
    return None


def as_compiled(obj, *, backend: str = "torch") -> CompiledBankingPlan:
    """Coerce to a CompiledBankingPlan.

    Accepts an artifact (pass-through), any object with a ``compile``
    method (a BankingPlan, compiled through its planner's cache when it
    has one), or -- deprecated -- a raw BankingSolution, which is compiled
    ad hoc.
    """
    if isinstance(obj, CompiledBankingPlan):
        return obj
    compile_method = getattr(obj, "compile", None)
    if compile_method is not None:          # BankingPlan
        return compile_method(backend=backend)
    if isinstance(obj, BankingSolution):
        warnings.warn(
            "passing a raw BankingSolution to kernels is deprecated; "
            "compile the solution (compile_solution) and pass the "
            "CompiledBankingPlan artifact",
            DeprecationWarning, stacklevel=3)
        return compile_solution(obj, backend=backend)
    raise TypeError(f"cannot compile {type(obj).__name__}")


__all__ = [
    "BankingLayout",
    "CompiledBankingPlan",
    "as_compiled",
    "compile_geometry",
    "compile_plan",
    "compile_solution",
    "compile_trivial",
    "graph_from_json",
    "graph_to_json",
    "lane_compile",
    "lower_np",
]

"""Banking-solver -> partition-spec bridge.

Device-level banking: a tensor accessed by the unrolled lanes of
data/tensor/expert-parallel execution is an array accessed by a concurrent
access group; mesh axes are banks.  For each tensor *role* the matching
1-D banking problem goes to the solver -- lanes = mesh axis size, array
dim = the candidate partition dim -- and the partition dimension whose
hyperplane (N = axis size, B = 1, alpha = unit) is conflict-free with
fan-out 1 is accepted (each lane owns one shard: no crossbar, no
collective on the access path).  Dims that cannot bank conflict-free (8 kv
heads across a 16-way axis) fall back to the next candidate dim.

The banking problems are submitted through the shared ``PlanService``
(the serving runtime's front door, so lane problems share its plan store
and in-flight dedup); the qualifying scheme comes back as a compiled
artifact (``core.artifact.lane_compile``) whose ``to_partition_spec``
places the banked dim on a mesh axis.

The rules are the JAX package's, entry for entry.  A spec is a
:class:`PartitionSpec` -- a tuple with one entry per tensor dim: ``None``,
a mesh axis name, or a tuple of names sharded jointly, major to minor --
and :func:`placements` turns one into the ``Shard``/``Replicate``
placements of a ``DeviceMesh`` (the JAX package's ``NamedSharding``).  A
mesh is anything with ``axis_names`` and a ``shape`` by name
(``launch.mesh.MeshShape``) or a ``DeviceMesh``.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from ..configs.base import ArchConfig, ShapeConfig
from ..core.artifact import CompiledBankingPlan, lane_compile
from ..core.controller import AccessDecl, Counter, Ctrl, Program, Sched
from ..core.polytope import Affine, MemorySpec
from ..core.service import default_service
from ..core.solver import SolverOptions


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), an axis name, or a
    tuple of axis names sharded jointly, major to minor -- the JAX
    package's ``PartitionSpec``, compared entry by entry.  As there, a
    list of names is a tuple, and a tuple of one name that name."""

    def __new__(cls, *entries):
        def entry(e):
            if isinstance(e, (tuple, list)):
                return e[0] if len(e) == 1 else tuple(e)
            return e

        return super().__new__(cls, tuple(entry(e) for e in entries))

    def __getnewargs__(self):
        # unpickled as ``PartitionSpec(*entries)``: a spec crosses processes
        return tuple(self)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_axes(mesh) -> Dict[str, int]:
    """A mesh's axis sizes by name, major to minor: a ``DeviceMesh``'s
    ``mesh_dim_names`` and ``shape``, or ``axis_names`` and ``shape`` of
    a mesh description."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return {a: mesh.shape[a] for a in mesh.axis_names}


@functools.lru_cache(maxsize=None)
def lane_artifact(dim_size: int, lanes: int) -> Optional[CompiledBankingPlan]:
    """Compiled conflict-free FO=1 lane banking of `dim_size`, or None.

    Poses the canonical strided access problem to the banking planner:
    lanes read disjoint contiguous blocks.  Equivalent to lanes | dim
    (block scheme), but answered by the solver so the decision is the
    paper's -- and returned as the compiled artifact whose
    ``to_partition_spec`` places the banked dim on a mesh axis.
    """
    if lanes <= 1 or dim_size < lanes or dim_size % lanes:
        return None
    blk = dim_size // lanes
    mem = MemorySpec("t", dims=(dim_size,), ports=1)
    # lane l owns the contiguous block [l*blk, (l+1)*blk): the outer
    # counter supplies the lane, the inner synchronized one the offset
    prog = Program(
        root=Ctrl("rd", Sched.INNER,
                  counters=[Counter("o", 0, 1, lanes, par=lanes),
                            Counter("j", 0, 1, blk)],
                  accesses=[AccessDecl("t", (Affine.of(o=blk, j=1),))]),
        memories={"t": mem},
    )
    opts = SolverOptions(max_solutions=4, n_budget=8,
                         b_candidates=(blk, 1) if blk > 1 else (1,),
                         allow_multidim=False, allow_duplication=False)
    plan = default_service().submit(prog, "t", opts=opts).result()
    return lane_compile(plan, lanes)


def bankable(dim_size: int, lanes: int) -> bool:
    """Can `dim_size` be banked conflict-free FO=1 across `lanes` lanes?"""
    return lanes <= 1 or lane_artifact(dim_size, lanes) is not None


def first_bankable(dims: Sequence[int], candidates: Sequence[int],
                   lanes: int) -> Optional[int]:
    for d in candidates:
        if d < len(dims) and bankable(dims[d], lanes):
            return d
    return None


# ---------------------------------------------------------------------------
# Mesh-axis vocabulary
# ---------------------------------------------------------------------------


def dp_axes(mesh) -> Tuple[str, ...]:
    names = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def tp_axis(mesh) -> str:
    return "model"


def sequence_parallel_layout(mesh) -> Dict[str, PartitionSpec]:
    """The attention families' activation layout at train and prefill
    (Megatron-SP): the residual stream cut on the sequence over
    ``model``, the block inputs whole."""
    dp = dp_axes(mesh)
    return {"residual": P(dp, "model", None), "block_in": P(dp, None, None)}


# ---------------------------------------------------------------------------
# Parameter sharding rules (driven by `bankable`)
# ---------------------------------------------------------------------------

# role table: candidate tp dims counted from the last dim, per leaf name
ROLE_TP_DIMS = {
    # attention
    "wq": (0,), "wk": (0,), "wv": (0,), "wo": (1,),
    "bq": (0,), "bk": (0,), "bv": (0,),
    # mlps (gate/up shard F=last, down shards F=first-of-trailing-2)
    "w_gate": (0,), "w_up": (0,), "w_down": (1,),
    "b_up": (0,), "b_down": (),
    # embeddings / heads: shard vocab
    "embed": (1,), "lm_head": (1,),
    # moe: shard experts (dim -3 of (E, D, F))
    "we_gate": (2,), "we_up": (2,), "we_down": (2,),
    "router": (0,),
    # ssm
    "in_proj": (0,), "out_proj": (1,), "conv_w": (0,), "conv_b": (0,),
    "A_log": (0,), "D_skip": (0,), "dt_bias": (0,), "gate_ln": (0,),
}


def _param_spec(path: str, shape: Tuple[int, ...], tp_size: int,
                fsdp_size: int, fsdp: bool,
                fsdp_axes: Tuple[str, ...] = ("data",)) -> PartitionSpec:
    """Choose (tp_dim, fsdp_dim) for one parameter by role."""
    nd = len(shape)
    name = path.split("/")[-1]
    spec = [None] * nd
    for c in ROLE_TP_DIMS.get(name, ()):
        d = nd - 1 - c
        if d < 0:
            continue
        if tp_size <= 1:
            spec[d] = "model"   # single-lane axis: placement is free
            break
        art = lane_artifact(shape[d], tp_size)
        if art is not None:
            # the artifact's own bridge places the banked (single) dim of
            # its 1-D problem on the mesh axis
            spec[d] = art.to_partition_spec("model")[0]
            break
    if fsdp:
        # ZeRO-3 style: also cut the largest remaining dim across data
        # (and pod, for optimizer state -- fsdp_axes=("data", "pod"))
        fsdp_entry = fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]
        order = sorted(range(nd), key=lambda d: -shape[d])
        for d in order:
            if spec[d] is not None or shape[d] < 2 * fsdp_size:
                continue
            if fsdp_size <= 1:
                spec[d] = fsdp_entry
                break
            art = lane_artifact(shape[d], fsdp_size)
            if art is not None:
                spec[d] = art.to_partition_spec(fsdp_entry)[0]
                break
    return PartitionSpec(*spec)


def param_specs(params_shape: Any, mesh, fsdp: bool = False,
                fsdp_axes: Tuple[str, ...] = ("data",)) -> Any:
    """PartitionSpec tree matching a params shape tree (nested dicts whose
    leaves have ``.shape``: tensors on the ``meta`` device do)."""
    axes = mesh_axes(mesh)
    tp_size = axes["model"]
    fsdp_axes = tuple(a for a in fsdp_axes if a in axes)
    fsdp_size = 1
    for a in fsdp_axes:
        fsdp_size *= axes[a]

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in tree.items()}
        return _param_spec(prefix, tuple(tree.shape), tp_size, fsdp_size,
                           fsdp, fsdp_axes or ("data",))

    return walk(params_shape, "")


def expert_specs(params_shape: Any) -> Any:
    """The spec tree of the expert-parallel cut: every expert stack
    (``we_*``) cut on its experts (dim -3) over ``model``, every other
    leaf whole -- what a rank of ``models.moe.moe_ffn_a2a`` holds
    (``convert.for_ranks(experts=)``) and declares (``"__params__"``)."""
    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        nd = len(tree.shape)
        return PartitionSpec(*("model" if name.startswith("we_")
                               and d == nd - 3 else None
                               for d in range(nd)))

    return walk(params_shape, "")


# ---------------------------------------------------------------------------
# A rank's blocks of a parameter tree (tensor parallelism)
# ---------------------------------------------------------------------------

# the dim of a leaf that holds its heads, from the last, and the kind of
# head along it (its width: ``head_widths``).  A cut of a Mamba2 head dim
# must fall on a head boundary; an attention leaf may be cut anywhere
# (``head_span`` gives a rank's columns and the heads they touch, and the
# layer gathers across them), and so may Mamba2's ``in_proj``, ``conv_w``
# and ``conv_b`` (``models/ssm.py`` gathers across them).
HEAD_DIMS = {"wq": (1, "attention"), "wk": (1, "attention"),
             "wv": (1, "attention"), "bq": (1, "attention"),
             "bk": (1, "attention"), "bv": (1, "attention"),
             "wo": (2, "attention"),
             "A_log": (1, "ssm_heads"), "D_skip": (1, "ssm_heads"),
             "dt_bias": (1, "ssm_heads"), "gate_ln": (1, "ssm"),
             "out_proj": (2, "ssm")}
# the kinds whose cuts must fall on head boundaries
WHOLE_HEAD_KINDS = ("ssm_heads", "ssm")


def head_widths(cfg: ArchConfig) -> Dict[str, int]:
    """The width of one head along each kind of head dim of
    ``HEAD_DIMS``: an attention head's ``hd``, a Mamba2 head's
    ``ssm_head_dim`` channels, and one entry in Mamba2's per-head leaves;
    a kind the config lacks is left out."""
    out = {"ssm_heads": 1}
    if cfg.n_heads:
        out["attention"] = cfg.hd
    if cfg.ssm_state:
        out["ssm"] = cfg.ssm_head_dim
    return out


def mesh_coords(mesh) -> Dict[str, int]:
    """This process's coordinate on each axis of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def head_span(width: int, n: int, m: int, head: int
              ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Rank ``m``'s columns ``(lo, hi)`` of a head leaf ``width`` columns
    wide cut into ``n`` contiguous blocks over ``model`` (``wq``'s
    columns, ``wo``'s rows), and the whole heads ``(h0, h1)`` of ``head``
    columns that the range touches: on a head boundary ``h1 - h0`` is
    the rank's own heads, else one or two heads more, shared with the
    neighbouring ranks (3.5 heads a rank touch 4)."""
    if width % n:
        raise ValueError(f"{width} columns do not divide by {n} ranks")
    blk = width // n
    lo, hi = m * blk, (m + 1) * blk
    return (lo, hi), (lo // head, -(-hi // head))


def _live_cuts(spec: PartitionSpec, axes: Dict[str, int]):
    """``(dim, axes major to minor)`` of every dim that ``spec`` cuts over
    axes of more than one rank: a tuple entry in the tuple's order, which
    need not be the mesh's (``('data', 'pod')`` is data-major on a mesh
    ``('pod', 'data', 'model')``)."""
    for d, entry in enumerate(spec):
        live = [a for a in ((entry,) if isinstance(entry, str) else
                            (entry or ())) if axes[a] > 1]
        if live:
            yield d, live


def block_index(live: Sequence[str], axes: Dict[str, int],
                coords: Dict[str, int]) -> Tuple[int, int]:
    """``(blocks, index)``: the number of blocks a dim cut over ``live``
    (major to minor) is cut into, and the one at ``coords``."""
    n, i = 1, 0
    for a in live:
        n, i = n * axes[a], i * axes[a] + coords[a]
    return n, i


def _cut(t, d: int, n: int, i: int, what: str):
    """Block ``i`` of ``n`` contiguous blocks of ``t`` along ``d``, a
    view."""
    if t.shape[d] % n:
        raise ValueError(f"{what}: dim {d} of {tuple(t.shape)} does not "
                         f"divide by {n}")
    b = t.shape[d] // n
    return t[(slice(None),) * d + (slice(i * b, (i + 1) * b),)]


def weight_cuts(path: str, spec: PartitionSpec, axes: Dict[str, int]):
    """:func:`_live_cuts` of a weight's spec, checked: ``model`` cuts one
    dim at most, and alone (the data axes, ZeRO-3, may cut any other)."""
    cuts = list(_live_cuts(spec, axes))
    model = [d for d, live in cuts if "model" in live]
    if len(model) > 1:
        raise ValueError(f"{path}: {spec!r} cuts two dims over 'model'")
    for d, live in cuts:
        if "model" in live and live != ["model"]:
            raise ValueError(f"{path}: {spec!r} cuts dim {d} over {live}: "
                             f"'model' and another axis on one dim")
    return cuts


def leaf_block(path: str, leaf, spec: PartitionSpec, axes: Dict[str, int],
               coords: Dict[str, int], head_dim=None):
    """This rank's block of one leaf (tensor or numpy array) under
    ``spec``: a view, the contiguous range at this rank's coordinates of
    every dim that ``spec`` cuts -- over ``model`` (tensor parallelism)
    and over the data axes (ZeRO-3), a tuple entry's axes major to minor
    (:func:`weight_cuts`).  An attention leaf's block may split a head
    (:func:`head_span`); where the cut of a Mamba2 head dim over
    ``model`` (``HEAD_DIMS``, ``WHOLE_HEAD_KINDS``) would not fall on a
    boundary of a head it raises, naming the leaf and the spec.
    ``head_dim``: the widths of every kind of head (:func:`head_widths`);
    a number is the attention heads' width, which no cut must respect."""
    name = path.rsplit("/", 1)[-1]
    widths = head_dim if isinstance(head_dim, dict) else {}
    at_dim, kind = HEAD_DIMS.get(name, (None, None))
    width = widths.get(kind) if kind in WHOLE_HEAD_KINDS else None
    for d, live in weight_cuts(path, spec, axes):
        n, i = block_index(live, axes, coords)
        if leaf.shape[d] % n:
            raise ValueError(f"{path}: dim {d} of {tuple(leaf.shape)} does "
                             f"not divide by the {live} axes' {n} ranks "
                             f"({spec!r})")
        blk = leaf.shape[d] // n
        if (live == ["model"] and width and d == len(leaf.shape) - at_dim
                and blk % width):
            raise ValueError(
                f"{path}: {spec!r} cuts dim {d} ({leaf.shape[d]}) over a "
                f"'model' axis of {n} into blocks of {blk}, not whole heads "
                f"of {width}: a Mamba2 head is not split")
        leaf = _cut(leaf, d, n, i, path)
    return leaf


def rank_blocks(tree: Any, specs: Any, mesh, coords: Dict[str, int],
                head_dim=None) -> Any:
    """This rank's block of every leaf of a parameter tree (nested dicts
    of tensors or numpy arrays, views where the layout allows) under its
    spec tree (:func:`param_specs`) on ``mesh``, at ``coords`` (axis name
    -> index, :func:`mesh_coords`).  A leaf that its spec leaves whole,
    or cuts over axes of size 1 only, stays whole.  ``head_dim`` as in
    :func:`leaf_block`."""
    axes = mesh_axes(mesh)

    def walk(t, s, prefix):
        if isinstance(t, dict):
            return {k: walk(v, s[k], f"{prefix}/{k}" if prefix else k)
                    for k, v in t.items()}
        return leaf_block(prefix, t, s, axes, coords, head_dim)

    return walk(tree, specs, "")


def _coords_of(r: int, axes: Dict[str, int]) -> Dict[str, int]:
    """The coordinates of rank ``r`` of a mesh in row-major order."""
    out = {}
    for a in reversed(list(axes)):
        r, out[a] = divmod(r, axes[a])
    return out


def _join(parts: Sequence[Any], spec: PartitionSpec, axes: Dict[str, int],
          what: str):
    """One tensor whole from every rank's block of it under ``spec``
    (``parts`` by rank, in the mesh's row-major order): the blocks joined
    over every live axis that cuts a dim, major to minor as the spec names
    them.  Ranks that hold the same block must hold the same values
    (``meta`` tensors are not compared)."""
    cuts = list(_live_cuts(spec, axes))
    blocks = {}
    for r, t in enumerate(parts):
        c = _coords_of(r, axes)
        key = tuple(c[a] for _, live in cuts for a in live)
        if key in blocks and (isinstance(t, np.ndarray)
                              or t.device.type != "meta"):
            same = (np.array_equal(np.asarray(blocks[key]), np.asarray(t))
                    if isinstance(t, np.ndarray) else
                    bool((blocks[key] == t).all()))
            if not same:
                raise ValueError(f"ranks hold different values of the "
                                 f"block {key} of {what} ({spec!r})")
        blocks.setdefault(key, t)

    def cat(ps, d):
        if isinstance(ps[0], np.ndarray):
            return np.concatenate(ps, axis=d)
        import torch
        return torch.cat(ps, dim=d)

    def build(prefix, rest):
        if not rest:
            return blocks[prefix]
        (d, live), more = rest[0], rest[1:]
        n = block_index(live, axes, {a: 0 for a in live})[0]
        out = []
        for i in range(n):
            sub, j = [], i
            for a in reversed(live):
                j, k = divmod(j, axes[a])
                sub.insert(0, k)
            out.append(build(prefix + tuple(sub), more))
        return cat(out, d)

    return build((), cuts)


def join_blocks(trees: Sequence[Any], specs: Any, mesh) -> Any:
    """The whole tree from every rank's blocks (``trees`` by rank, in the
    mesh's row-major order), :func:`rank_blocks`' inverse: each leaf
    joined over every axis that cuts it (``model`` and the data axes); a
    rank that holds a block another rank holds too must hold the same
    values.  numpy arrays or tensors."""
    axes = mesh_axes(mesh)

    def walk(ts, s, prefix):
        if isinstance(ts[0], dict):
            return {k: walk([t[k] for t in ts], s[k],
                            f"{prefix}/{k}" if prefix else k)
                    for k in ts[0]}
        return _join(ts, s, axes, prefix)

    return walk(list(trees), specs, "")


def cache_blocks(cache, specs, mesh, coords: Dict[str, int]):
    """This rank's block of every tensor of a decode cache (the family's
    cache type) under :func:`cache_specs` on ``mesh`` at ``coords``: each
    dim cut over every live axis its spec names (the batch over ``data``
    too), views; other fields (``pos``) as they are."""
    axes = mesh_axes(mesh)

    def block(t, spec):
        if not hasattr(t, "shape") or not len(getattr(t, "shape", ())):
            return t
        for d, live in _live_cuts(spec, axes):
            t = _cut(t, d, *block_index(live, axes, coords),
                     f"cache ({spec!r})")
        return t

    return type(cache)(*(block(t, s) for t, s in zip(cache, specs)))


def join_caches(caches: Sequence[Any], specs, mesh):
    """The whole cache from every rank's blocks (``caches`` by rank, in
    the mesh's row-major order), :func:`cache_blocks`' inverse: a rank
    that holds a block another rank holds too must hold the same values.
    numpy arrays or tensors; other fields as the first rank holds them."""
    axes = mesh_axes(mesh)

    def join(field, spec):
        if not hasattr(field[0], "shape") or not len(field[0].shape):
            return field[0]
        return _join(field, spec, axes, "a cache")

    return type(caches[0])(*(join([c[i] for c in caches], s)
                             for i, s in enumerate(specs)))


def state_cuts(param_spec: PartitionSpec, state_spec: PartitionSpec,
               axes: Dict[str, int]):
    """How a leaf's optimizer state cut by ``state_spec`` (ZeRO-1: the
    dry-run's opt specs) lies in the rank's block of the weight cut by
    ``param_spec``: ``[(dim, axes major to minor)]``, the live axes that
    cut the state's dim beyond the weight's.  On every dim the weight's
    live axes must lead the state's (the state a block of the weight's
    block)."""
    weight = dict(_live_cuts(param_spec, axes))
    out = []
    for d, live in _live_cuts(state_spec, axes):
        have = weight.pop(d, [])
        if live[:len(have)] != have:
            raise ValueError(f"a state cut {state_spec!r} is not a block "
                             f"of the weight's {param_spec!r} on dim {d}")
        if len(live) > len(have):
            out.append((d, live[len(have):]))
    if weight:
        raise ValueError(f"a state cut {state_spec!r} leaves whole dims "
                         f"{sorted(weight)} the weight's {param_spec!r} "
                         f"cuts")
    return out


# ---------------------------------------------------------------------------
# Batch / cache / activation sharding per shape-kind
# ---------------------------------------------------------------------------


def batch_specs(cfg: ArchConfig, shape: ShapeConfig, mesh
                ) -> Dict[str, PartitionSpec]:
    axes = mesh_axes(mesh)
    dp = dp_axes(mesh)
    dp_size = 1
    for a in dp:
        dp_size *= axes[a]
    bdim = dp if shape.global_batch >= dp_size \
        else dp[:1] if shape.global_batch > 1 else ()
    b = bdim if bdim else None
    specs = {"tokens": P(b, None), "labels": P(b, None)}
    if cfg.family == "encdec":
        specs["frames"] = P(b, None, None)
    return specs


def _seq_or_heads(mesh, heads: int, long: bool) -> Tuple[Any, Any]:
    """(head_axis_spec, seq_axis_spec) for KV caches."""
    if not long and bankable(heads, mesh_axes(mesh)["model"]):
        return "model", None
    return None, "model"


def cache_specs(cfg: ArchConfig, shape: ShapeConfig, mesh) -> Any:
    """PartitionSpec tree for the family's decode cache (the family's
    cache type, a spec in each field)."""
    dp = dp_axes(mesh)
    long = shape.kind == "long_decode"
    nb = None if shape.global_batch == 1 else dp
    fam = cfg.family
    if fam in ("dense", "vlm", "moe"):
        h_ax, s_ax = _seq_or_heads(mesh, cfg.n_kv_heads, long)
        if long and shape.global_batch == 1:
            # B=1: spread the huge cache over every axis there is
            kv = P(None, None, tuple(a for a in (*dp, "model")), None, None)
        else:
            kv = P(None, nb, s_ax, h_ax, None)
        from ..models.transformer import KVCache
        return KVCache(k=kv, v=kv, pos=P())
    if fam == "ssm":
        from ..models.ssm import SSMCache
        return SSMCache(conv=P(None, nb, None, "model"),
                        state=P(None, nb, "model", None, None),
                        pos=P())
    if fam == "hybrid":
        from ..models.hybrid import HybridCache
        h_ax, s_ax = _seq_or_heads(mesh, cfg.n_kv_heads, long)
        if long and shape.global_batch == 1:
            kv = P(None, None, tuple(a for a in (*dp, "model")), None, None)
        else:
            kv = P(None, nb, s_ax, h_ax, None)
        return HybridCache(conv=P(None, None, nb, None, "model"),
                           state=P(None, None, nb, "model", None, None),
                           k=kv, v=kv, pos=P())
    if fam == "encdec":
        from ..models.encdec import EncDecCache
        h_ax, s_ax = _seq_or_heads(mesh, cfg.n_kv_heads, long)
        kv = P(None, nb, s_ax, h_ax, None)
        return EncDecCache(k_self=kv, v_self=kv, k_cross=kv, v_cross=kv,
                           pos=P())
    raise ValueError(fam)


def ring_cache_specs(cfg: ArchConfig, shape: ShapeConfig, mesh) -> Any:
    """The ``GroupedKVCache`` of specs of ``grouped_decode_step``'s cache
    (the dry-run's ``ring_cache`` cell): the local layers' rings
    ``(G, R, B, W, Hkv, Dh)`` cut on the batch over the data axes and
    whole over ``model`` at a batch of more than one row, their ``W``
    rows cut over ``model`` at one; the global layers' buffers ``(G, B,
    Smax, Hkv, Dh)`` cut on their positions over ``model``, or over the
    data axes then ``model`` at one row."""
    from ..models.transformer import GroupedKVCache

    dp = dp_axes(mesh)
    one = shape.global_batch == 1
    nb = None if one else dp
    seq_all = (*dp, "model") if one else "model"
    kv_loc = P(None, None, nb, "model" if one else None, None, None)
    kv_glob = P(None, nb, seq_all, None, None)
    return GroupedKVCache(k_local=kv_loc, v_local=kv_loc, k_global=kv_glob,
                          v_global=kv_glob, pos=P())


def quant_cache_specs(cfg: ArchConfig, shape: ShapeConfig, mesh) -> Any:
    """The ``QuantKVCache`` of specs of ``decode_step_quant``'s cache (the
    dry-run's ``int8_kv`` cell): the int8 rows cut as :func:`cache_specs`
    cuts ``k``, the scales as ``k`` less its last dim."""
    from ..models.transformer import QuantKVCache

    kv = cache_specs(cfg, shape, mesh).k
    scale = P(*kv[:-1])
    return QuantKVCache(k_q=kv, v_q=kv, k_s=scale, v_s=scale, pos=P())


def logits_spec(mesh, batch_sharded: bool = True) -> PartitionSpec:
    dp = dp_axes(mesh)
    return P(dp if batch_sharded else None, "model")


# ---------------------------------------------------------------------------
# DeviceMesh placements (the JAX package's NamedSharding)
# ---------------------------------------------------------------------------


def placements(spec: PartitionSpec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``:
    one per mesh dim, ``Shard(d)`` where tensor dim ``d`` names that axis,
    else ``Replicate()``.

    A tuple entry shards one tensor dim over several axes, major to minor.
    DTensor splits a dim sharded on several mesh dims in mesh-dim order,
    the first the major one, so the entry's axes must come in the mesh's
    order; another order has no plain ``Shard`` form and is refused."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(
                f"entry {entry!r} of {spec!r} shards dim {d} over axes "
                f"major to minor against the mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


__all__ = [
    "P", "PartitionSpec", "ROLE_TP_DIMS", "bankable", "batch_specs",
    "block_index", "cache_blocks", "cache_specs",
    "dp_axes", "first_bankable",
    "head_span", "head_widths", "join_blocks", "join_caches", "lane_artifact",
    "leaf_block", "logits_spec", "mesh_axes", "mesh_coords", "param_specs",
    "placements", "quant_cache_specs", "rank_blocks", "ring_cache_specs",
    "state_cuts", "tp_axis", "weight_cuts",
]

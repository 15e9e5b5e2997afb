"""Named activation-sharding hints.

Models call ``hint(x, "residual")`` at layout-critical points; the trainer
or the dry-run installs a policy mapping hint names to partition specs for
the current (arch x shape x mesh) cell.  Without a policy the calls are
no-ops that return their argument itself, so single-device runs are
untouched.  The policy is per thread, as in the JAX package.

This is the activation-side twin of the parameter banking bridge
(``parallel/sharding.py``).  On a ``DTensor`` a hint redistributes to the
spec's placements on the tensor's own mesh -- the JAX package's
``with_sharding_constraint``.  Entries that are not specs (``"__mesh__"``,
the live ``DeviceMesh`` the expert-parallel MoE layer reads,
``"__fsdp__"``, the dry-run's flag, which the passes read through
``"__params__"``, ``"__cache__"``, the decode cache's layout,
``"__params__"``, the parameters', and ``"__opt__"``, the optimizer
state's) are read with :func:`policy_value`.

``"__params__"`` declares the spec tree the ranks' weights were cut by
(``parallel.sharding.param_specs``, ``convert.for_ranks``).  Where it
cuts a leaf over the data axes (ZeRO-3), a pass gathers the leaf into its
``model`` block where it is used, layer by layer (:func:`layer_blocks`,
inside the layer's recomputed body; :func:`whole_layers` for a stack
whose layer dim is cut; :func:`model_block` for the whole-model leaves),
and the gather's gradient is the reduce-scatter, summed in float32.
Every reading of a leaf's cut -- the gradients' sums
(``models.transformer.spread_grads``), the global norm -- takes the
declared spec, over ``model`` as over the data axes; without the entry
every leaf is whole (:func:`cut_axes`).  A world whose ranks hold cut
weights -- tensor parallelism, the expert-parallel experts
(``parallel.sharding.expert_specs``), ZeRO-3 -- declares them.
``"__opt__"`` declares the
optimizer state's spec tree (the dry-run's opt specs, cut over the data
axes: ZeRO-1); where it cuts a leaf beyond its weight, each rank updates
its own block of the state and gathers the new weight over the data axes
(:func:`state_layout`).

``"__cache__"`` declares how a prefill or a decode step holds the KV
cache: ``parallel.sharding.cache_specs(cfg, shape, mesh)`` of the shape
being served, a spec in each field of the family's cache type.  Where a
KV field's spec cuts the positions (dim 2) over live axes, a rank holds
its block of ``Smax/n`` positions of every kv head (:func:`cache_cut`,
:class:`SequenceCut`: ``n`` is ``model``, or ``data`` x ``model``, data
major, under ``long_decode`` at batch 1) and its attention over the cache
is a partial softmax merged over those ranks; where it cuts the kv heads
(dim 3), the rank's kv heads.  Without the entry the layout follows the
weights: a rank's kv heads where ``wk`` is cut on a head boundary, every
kv head and position otherwise.

A plain tensor is process-local: its rows are this rank's rows of the
batch (the caller cuts dim 0 over the data axes), so a spec's batch entry
asks nothing of it.  Under a policy that holds a ``"__mesh__"`` with a
``model`` axis of ``n > 1``, a pass over a whole sequence of length ``S``
(``S % n == 0``) whose ``"residual"`` spec cuts dim 1 over ``model``
declares itself with :func:`split_sequence`; while it runs, a hint on a
plain tensor converts between the whole sequence and this rank's block
(Megatron sequence parallelism):

* a spec that cuts dim 1 over ``model`` (``"residual"``) keeps this
  rank's block ``S/n`` of a whole sequence, and passes a block;
* a spec that names ``model`` nowhere (``"block_in"``) all-gathers a
  block over the ``model`` group in rank order, and passes a whole one.

Every other spec passes a plain tensor through, as does every hint
outside such a pass.  Two of them are already in their process-local
form when a layer's weights are cut over ``model`` (tensor parallelism,
``parallel.sharding.rank_blocks``): the vocabulary cut of ``"logits"``
(``P(dp, None, "model")``) is the ``V/n`` columns that this rank's
``lm_head`` rows give, and the expert cut of ``"expert_buffer"``
(``P("model", None, None)``) the ``E/n`` experts' rows of the buffer that
this rank's expert weights take; with whole weights both are whole.
The cut is made by the weights, so the hint passes either.

The SSM and hybrid families cut the residual on its channels instead
(``"residual"`` is ``P(dp, None, "model")``: the SSD scan cannot have its
sequence cut).  Their passes declare the residual's width ``D`` too
(``split_sequence(S, channels=D)``); where ``model`` divides it, a
:class:`Split` of ``dim`` 2 holds, under which

* the residual between blocks is this rank's ``D/n`` channels (the
  ``"residual"`` hint keeps them; no other hint reads the channel cut:
  ``"logits"`` names the same spec for the vocabulary);
* a block's input is all-gathered on its channels before its first norm
  (:func:`whole_channels`), and the gradient of the gather is
  reduce-scattered, summed in float32: each rank's partial cotangent of
  the gathered input is summed over ``model`` there, once, so
  :func:`column_in` passes its input untouched under such a cut;
* :func:`row_parallel_end` reduce-scatters the ranks' partial sums on the
  channels, in float32, and :func:`residual_block` takes this rank's
  channels of an output computed whole.

The gains of the norms that read the gathered input (``ln``, ``ln1``,
``ln2``, ``ln_f``) are whole in every rank and take a partial gradient
there; ``models.transformer.spread_grads`` sums them over ``model``, as
it sums every whole leaf of a pass whose tokens or channels are cut.
Decode has no ``"residual"`` entry in the policy: its residual stays
whole and the row-parallel ends all-reduce.

A layer knows that it is tensor-parallel from its weights' shapes, never
from a flag.  Its products with weights cut on their output columns take
:func:`column_in` of their input, and its products with weights cut on
their input rows end with :func:`row_parallel_end`, which sums the
ranks' partial sums over ``model`` (Megatron's f and g).
"""

from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Dict, Optional

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


@contextmanager
def policy_defaults(**entries):
    """The policy in force with ``entries`` added where it lacks them
    (nothing changes without a policy)."""
    pol = _policy()
    if pol is None or all(k in pol for k in entries):
        yield
        return
    with sharding_policy({**entries, **pol}):
        yield


def policy_value(name: str, default=None):
    """Non-spec policy entries (e.g. ``'__mesh__'`` for the expert-parallel
    MoE layer)."""
    pol = _policy()
    if pol is None:
        return default
    return pol.get(name, default)


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclass(frozen=True)
class Split:
    """How a pass's tokens lie over the live mesh: the residual's ``dim``
    (1: the sequence; 2: the channels, the SSM and hybrid families'
    cut) of length ``S`` cut into ``n`` blocks over the ``model`` group
    (``n == 1``: not cut, every ``model`` rank holds it whole), this
    rank's block ``rank``; the batch rows cut over the ``data`` group
    (``None`` where the mesh's data axis has one rank)."""

    S: int
    n: int
    rank: int
    model: object
    data: object
    n_data: int
    dim: int = 1

    @property
    def cut(self) -> bool:
        return self.n > 1

    @property
    def channels(self) -> bool:
        """Whether the residual's channels are cut (``dim`` 2)."""
        return self.cut and self.dim == 2

    def _whole(self, t, dim: int) -> bool:
        """Whether ``t`` is whole along ``dim`` (else this rank's block of
        it); any other length is a layout fault."""
        if t.shape[dim] not in (self.S, self.S // self.n):
            raise ValueError(
                f"a tensor of {t.shape[dim]} along dim {dim} in a pass "
                f"that cuts {self.S} in {self.n} blocks: neither the whole "
                f"of it nor a block")
        return t.shape[dim] == self.S

    def block(self, t, dim: int = None):
        """This rank's block of a whole ``t`` along ``dim`` (default: the
        cut dim; a block passes, and so does a tensor along a dim the
        pass does not cut)."""
        dim = self.dim if dim is None else dim
        if not self.cut or dim != self.dim or not self._whole(t, dim):
            return t
        b = self.S // self.n
        return t.narrow(dim, self.rank * b, b)

    def gather(self, t):
        """The whole of ``t`` along the cut dim from this rank's block of
        it (a whole one passes).  The channels' gather sums its gradient
        in float32."""
        if not self.cut or self._whole(t, self.dim):
            return t
        import torch

        from .collectives import all_gather_dim
        return all_gather_dim(t, self.dim, self.model,
                              torch.float32 if self.dim == 2 else None)

    def token_groups(self) -> tuple:
        """The groups over which this pass's tokens are spread."""
        return tuple(g for g, k in ((self.model, self.n),
                                    (self.data, self.n_data)) if k > 1)

    def mean(self, x):
        """The mean over every rank of a per-rank mean of as many tokens:
        a sum over :meth:`token_groups`, whose gradient passes through."""
        from .collectives import all_reduce_sum
        for g in self.token_groups():
            x = all_reduce_sum(x, g)
        return x / float(self.n * self.n_data)

    def mean_with_model(self, x):
        """:meth:`mean` with the ``model`` group taken in where the
        sequence is not cut: the mean of a value each rank of a
        tensor-parallel ``model`` group holds alike (the load-balancing
        loss), so that each rank's gradient is its share of it."""
        if self.cut:
            return self.mean(x)
        from .collectives import all_reduce_sum
        group, n_model, _ = model_axis()
        return all_reduce_sum(self.mean(x), group) / float(n_model)

    def row_mean(self, x):
        """The mean over the ``data`` group of ``x``, a value each rank of
        a ``model`` group holds alike (the vocabulary-parallel
        cross-entropy of its data row's whole sequence); its gradient
        passes through."""
        if self.n_data == 1:
            return x
        from .collectives import all_reduce_sum
        return all_reduce_sum(x, self.data) / float(self.n_data)

    def batch_mean(self, x):
        """The mean over the ``data`` group of ``x``, a mean over this
        rank's rows (as many in every rank), outside autograd."""
        if self.n_data == 1:
            return x
        import torch.distributed as dist
        x = x.detach().clone()
        dist.all_reduce(x, group=self.data)
        return x / float(self.n_data)

    def last_block(self, t):
        """``t`` of the rank holding the last block of the sequence, in
        every rank of the ``model`` group (a broadcast from it)."""
        if not self.cut or self.dim != 1:
            return t
        import torch.distributed as dist
        t = t.contiguous()
        dist.broadcast(t, src=dist.get_global_rank(self.model, self.n - 1),
                       group=self.model)
        return t


def _sequence_split(S: int, cut: bool, channels: Optional[int]
                    ) -> Optional[Split]:
    """The :class:`Split` of a pass over ``S`` tokens a row under the
    policy in force: ``None`` without a ``"__mesh__"``; where ``cut``,
    ``model`` has more than one rank and the policy's ``"residual"`` cuts
    over it, the sequence cut (dim 1, ``model`` divides ``S``) or, for a
    pass that gives its residual's width ``channels``, the channel cut
    (dim 2, ``model`` divides ``channels``)."""
    mesh = policy_value("__mesh__")
    if mesh is None:
        return None
    import torch.distributed as dist
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    length, n, rank, model, dim = S, 1, 0, None, 1
    if "model" in names:
        spec = policy_value("residual")
        n_model = mesh.size(names.index("model"))
        if cut and spec is not None and n_model > 1:
            if (len(spec) > 1 and "model" in _names(spec[1])
                    and S % n_model == 0):
                n = n_model
            elif (channels is not None and len(spec) > 2
                    and "model" in _names(spec[2])
                    and channels % n_model == 0):
                n, length, dim = n_model, channels, 2
        if n > 1:
            model = mesh.get_group("model")
            rank = dist.get_rank(model)
    data, n_data = None, 1
    if "data" in names and mesh.size(names.index("data")) > 1:
        data = mesh.get_group("data")
        n_data = mesh.size(names.index("data"))
    return Split(length, n, rank, model, data, n_data, dim)


def current_split() -> Optional[Split]:
    """The split of the pass in flight (:func:`split_sequence`), if any."""
    return getattr(_LOCAL, "split", None)


@contextmanager
def split_sequence(S: int, cut: bool = True, channels: Optional[int] = None):
    """Declare a pass over a whole sequence of ``S`` tokens a row (its
    residual ``channels`` wide, for a family whose ``"residual"`` may cut
    the channels): yields its :class:`Split` (``None`` without a mesh) and
    holds it for the hints until the pass ends."""
    old = current_split()
    _LOCAL.split = _sequence_split(S, cut, channels)
    try:
        yield _LOCAL.split
    finally:
        _LOCAL.split = old


def bound(fn):
    """``fn`` that runs under the policy and split in force now, wherever
    it is called: a layer recomputed in the backward (``layers.remat``)
    runs after its pass has ended and must take the same layout."""
    policy, split = _policy(), current_split()

    def run(*args):
        old_policy, old_split = _policy(), current_split()
        _LOCAL.policy, _LOCAL.split = policy, split
        try:
            return fn(*args)
        finally:
            _LOCAL.policy, _LOCAL.split = old_policy, old_split

    return run


@dataclass(frozen=True)
class SequenceCut:
    """A cache's positions cut into ``n`` contiguous blocks over the live
    mesh axes of its spec, major to minor; this rank holds block
    ``index``; ``groups``: those axes' process groups, over which the
    attention's partial softmax is merged."""

    n: int
    index: int
    groups: tuple

    def span(self, length: int):
        """This rank's positions ``(lo, hi)`` of a whole ``length``."""
        if length % self.n:
            raise ValueError(f"a cache of {length} positions does not cut "
                             f"into {self.n} blocks")
        b = length // self.n
        return self.index * b, (self.index + 1) * b

    def amax(self, t):
        """The elementwise max of ``t`` over the cut's ranks."""
        from .collectives import all_reduce_max
        for g in self.groups:
            t = all_reduce_max(t, g)
        return t

    def total(self, t):
        """The sum of ``t`` over the cut's ranks."""
        from .collectives import all_reduce_sum
        for g in self.groups:
            t = all_reduce_sum(t, g)
        return t


def cache_cut(field: str = "k", rows: int = 2):
    """The layout the policy's ``"__cache__"`` declares for the KV field
    ``field`` of the cache type it holds (the family's, or a decode
    variant's: ``GroupedKVCache``, ``QuantKVCache``) on its live
    ``"__mesh__"``: ``(SequenceCut or None, head blocks)``, the rows
    (dim ``rows``: a buffer's positions, a ring's slots at 3) cut into a
    ``SequenceCut``, the kv heads (the dim after them) into ``head
    blocks`` over ``model`` (1: every kv head); ``None`` where the policy
    declares nothing."""
    specs, mesh = policy_value("__cache__"), policy_value("__mesh__")
    if specs is None or mesh is None:
        return None
    names = tuple(mesh.mesh_dim_names)
    spec = getattr(specs, field)

    def live(d):
        return [a for a in (_names(spec[d]) if d < len(spec) else ())
                if mesh.size(names.index(a)) > 1]

    seq = None
    axes = live(rows)
    if axes:
        n, index = 1, 0
        for a in axes:
            k = mesh.size(names.index(a))
            n, index = n * k, index * k + mesh.get_local_rank(a)
        seq = SequenceCut(n, index, tuple(mesh.get_group(a) for a in axes))
    heads = 1
    for a in live(rows + 1):
        heads *= mesh.size(names.index(a))
    return seq, heads


def model_axis():
    """``(group, n, rank)`` of the ``model`` axis of the live mesh in the
    policy: what a layer whose weights are cut over ``model`` reduces
    over.  A cut weight without such a mesh is a layout fault."""
    mesh = policy_value("__mesh__")
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if "model" not in names:
        raise ValueError("weights cut over 'model' (tensor parallelism) "
                         "need a live DeviceMesh with a 'model' axis in "
                         "the sharding policy's '__mesh__'")
    return (mesh.get_group("model"), mesh.size(names.index("model")),
            mesh.get_local_rank("model"))


def column_in(h):
    """The input of products whose weights are cut on their output
    columns over ``model`` (``wq``/``wk``/``wv``, ``w_gate``/``w_up``,
    the router, ``lm_head``, ``in_proj``): under a sequence cut the whole
    sequence (the ``"block_in"`` gather; a whole ``h`` passes), whose
    gradient is reduce-scattered -- each rank's share summed; under a
    channel cut ``h`` itself, computed from the gathered channels
    (:func:`whole_channels`), whose gather sums the gradient; otherwise
    ``h`` itself, whose gradient is summed over ``model`` in the
    backward."""
    split = current_split()
    if split is not None and split.cut:
        return h if split.channels else split.gather(h)
    from .collectives import summed_grads
    return summed_grads(h, (model_axis()[0],))


def row_parallel_end(t):
    """The end of a product whose weight is cut on its input rows over
    ``model`` (``wo``, ``w_down``, the vocabulary-parallel embedding, the
    expert-cut combine): ``t`` holds this rank's partial sums over the
    whole sequence.  Under a sequence cut their sum is reduce-scattered
    into this rank's block (what :func:`residual_block` takes of a whole
    output), under a channel cut into this rank's channels; otherwise
    (decode, a sequence that ``model`` does not divide) all-reduced.
    Summed in float32, returned in ``t``'s dtype."""
    from .collectives import all_reduce_sum, reduce_scatter_dim
    group = model_axis()[0]
    split = current_split()
    if split is not None and split.cut:
        if not split._whole(t, split.dim):
            raise ValueError("a row-parallel product over a block of the "
                             "residual: its input must be whole")
        return reduce_scatter_dim(t.float(), split.dim, group).to(t.dtype)
    return all_reduce_sum(t.float(), group).to(t.dtype)


def residual_block(t):
    """``t``'s block of the sequence (or of the channels) where the pass
    in flight cuts it and ``t`` is whole, else ``t``: what the residual
    add takes of an output computed whole.  Not a hint: no spec is
    read."""
    split = current_split()
    return t if split is None else split.block(t)


def whole_channels(x):
    """The whole channels of the residual ``x`` where the pass in flight
    cuts them (all-gathered over ``model``; the gather's gradient is
    reduce-scattered, summed in float32), else ``x`` itself: a block's
    input before its first norm.  Not a hint: no spec is read."""
    split = current_split()
    return x if split is None or not split.channels else split.gather(x)


def hint(x, name: str):
    pol = _policy()
    if pol is None:
        return x
    spec = pol.get(name)
    if spec is None:
        return x
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        from .sharding import placements

        return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))
    split = current_split()
    if split is None or not split.cut:
        return x
    if split.channels:
        # the residual's channel cut; "logits" names the same spec for the
        # vocabulary, which the weights cut
        return split.block(x) if name == "residual" else x
    if len(spec) > 1 and "model" in _names(spec[1]):
        return split.block(x)
    if all("model" not in _names(e) for e in spec):
        return split.gather(x)
    return x


# ---------------------------------------------------------------------------
# Weights cut over the data axes (ZeRO-3) and the optimizer state (ZeRO-1)
# ---------------------------------------------------------------------------


def _mesh_sizes(mesh) -> Dict[str, int]:
    return {a: mesh.size(i) for i, a in enumerate(mesh.mesh_dim_names)}


def declared_spec(path: str, entry: str = "__params__"):
    """The spec the policy's ``"__params__"`` (or ``entry``: the
    optimizer state's ``"__opt__"``) declares for the leaf ``path``
    (``"layers/wq"``), or ``None`` where the policy declares none."""
    specs = policy_value(entry)
    if specs is None:
        return None
    for k in path.split("/"):
        specs = specs[k]
    return specs


def cut_axes(path: str, entry: str = "__params__") -> frozenset:
    """The live mesh axes that cut the leaf ``path``: those of the spec
    the policy's ``"__params__"`` (or ``entry``) declares for it, none
    where nothing is declared."""
    spec = declared_spec(path, entry)
    if spec is None:
        return frozenset()
    from .sharding import weight_cuts
    sizes = _mesh_sizes(policy_value("__mesh__"))
    return frozenset(a for _, live in weight_cuts(path, spec, sizes)
                     for a in live)


def _gathered(t, path: str, spec, dims):
    """``t`` with each of ``dims`` (``{dim of t: dim of spec}``) that
    ``spec`` cuts over the data axes all-gathered over them, minor axis
    first, in rank order; the gradient reduce-scattered, summed in
    float32.  A leaf whole over ``model`` in a pass whose tokens (or
    residual channels) are cut over ``model`` takes its gradient's sum
    over ``model`` here, before the data sum: the order of the same leaf
    held whole over the data axes (``models.transformer.spread_grads``),
    so that both give the same bits."""
    import torch

    from .collectives import all_gather_dim, summed_grads
    from .sharding import weight_cuts

    mesh = policy_value("__mesh__")
    cuts = weight_cuts(path, spec, _mesh_sizes(mesh))
    data = {d: live for d, live in cuts if live != ["model"]}
    done = False
    for at, d in dims.items():
        for a in reversed(data.get(d, ())):
            t = all_gather_dim(t, at, mesh.get_group(a), torch.float32)
            done = True
    split = current_split()
    if done and len(data) == len(cuts) and split is not None and split.cut:
        t = summed_grads(t, (split.model,))
    return t


@contextmanager
def gathered_once(params: Dict[str, Any], names):
    """``params`` with each whole-model leaf of ``names`` gathered into its
    ``model`` block once (:func:`model_block`), under a policy whose
    ``"__params__"`` declares them so (their data axes dropped), for a
    pass that uses a leaf more than once -- a tied embedding, the
    embedding and the head: in the backward the uses' gradients are summed
    before the one reduce-scatter, in the order of the same leaf whole
    over the data axes (their sum before the data sum), so that the two
    layouts give the same bits.  ``params`` itself where nothing is
    declared."""
    specs = policy_value("__params__")
    names = [n for n in names if n in params]
    if specs is None or not names:
        yield params
        return
    from .sharding import PartitionSpec

    out, declared = dict(params), dict(specs)
    for n in names:
        out[n] = model_block(params[n], n)
        declared[n] = PartitionSpec(*("model" if "model" in _names(e)
                                      else None for e in specs[n]))
    with sharding_policy({**_policy(), "__params__": declared}):
        yield out


def model_block(t, path: str):
    """``t``, this rank's block of the whole-model leaf ``path``
    (``embed``, ``ln_f``, ``lm_head``), as its ``model`` block: every dim
    the declared spec cuts over the data axes all-gathered
    (:func:`_gathered`); ``t`` itself where nothing is declared or no data
    axis cuts it."""
    spec = declared_spec(path)
    if spec is None:
        return t
    return _gathered(t, path, spec, {d: d for d in range(len(spec))})


def _tree(tree: Dict[str, Any], prefix: str, fn):
    """``fn(leaf, path)`` over a nested dict of leaves under ``prefix``."""
    return {k: _tree(v, f"{prefix}/{k}", fn) if isinstance(v, dict)
            else fn(v, f"{prefix}/{k}") for k, v in tree.items()}


def whole_layers(layers: Dict[str, Any], prefix: str = "layers",
                 lead: int = 1):
    """The stacked layer leaves (a nested dict under ``prefix``, each
    stacked on ``lead`` layer dims: 1, or the hybrid's ``(G, per)``) with
    each layer dim the declared spec cuts over the data axes gathered
    whole (biases and gains: a rank of qwen2-7b holds 14 of 28 layers'
    ``bq`` at (2, 2)), so that the stack unbinds into every layer; the
    others as they are."""
    if policy_value("__params__") is None:
        return layers
    return _tree(layers, prefix, lambda w, path: _gathered(
        w, path, declared_spec(path), {d: d for d in range(lead)}))


def layer_blocks(lp: Dict[str, Any], prefix: str = "layers", lead: int = 1):
    """One layer's leaves (slices of :func:`whole_layers`' stacks past
    their ``lead`` layer dims; ``lead`` 0 for a block that is not stacked,
    the hybrid's shared one), each as its ``model`` block: every dim past
    the layer dims that the declared spec cuts over the data axes
    all-gathered.  Called inside the layer's recomputed body
    (``layers.remat``), so that the gathered copies are not kept for the
    backward."""
    if policy_value("__params__") is None:
        return lp

    def gather(w, path):
        spec = declared_spec(path)
        return _gathered(w, path, spec,
                         {d - lead: d for d in range(lead, len(spec))})

    return _tree(lp, prefix, gather)


def model_shape(t, path: str) -> tuple:
    """The shape of the ``model`` block of the leaf ``path`` whose rank's
    block is ``t``: each dim the declared spec cuts over the data axes
    taken whole (``t``'s own shape where nothing is declared: no leaf is
    then cut over the data axes)."""
    spec = declared_spec(path)
    if spec is None:
        return tuple(t.shape)
    from .sharding import weight_cuts

    sizes = _mesh_sizes(policy_value("__mesh__"))
    shape = list(t.shape)
    for d, live in weight_cuts(path, spec, sizes):
        if live != ["model"]:
            shape[d] *= math.prod(sizes[a] for a in live)
    return tuple(shape)


@dataclass(frozen=True)
class StateCut:
    """A leaf's optimizer state as this rank's block of its weight block
    (ZeRO-1): ``cuts``, ``(dim, blocks, index, groups major to minor)``
    of each dim the state cuts beyond the weight."""

    cuts: tuple

    def take(self, t):
        """This rank's block of ``t``, shaped like the weight block."""
        for d, n, i, _ in self.cuts:
            b = t.shape[d] // n
            t = t.narrow(d, i * b, b)
        return t

    def put(self, block):
        """The weight block from every rank's ``block`` of it: gathered
        over each cut's groups, minor axis first, in rank order."""
        from .collectives import all_gather_dim
        for d, _, _, groups in reversed(self.cuts):
            for g in reversed(groups):
                block = all_gather_dim(block, d, g)
        return block


def state_layout(params: Dict[str, Any]):
    """The optimizer state's layout under the policy in force: a tree
    like ``params`` of :class:`StateCut` where the declared ``"__opt__"``
    cuts a leaf's state beyond the declared ``"__params__"``
    (``parallel.sharding.state_cuts``), ``None`` elsewhere; ``None``
    without ``"__opt__"``."""
    opt = policy_value("__opt__")
    if opt is None:
        return None
    weights, mesh = policy_value("__params__"), policy_value("__mesh__")
    if weights is None or mesh is None:
        raise ValueError("'__opt__' declares the optimizer state's cut "
                         "against the weights': the policy declares "
                         "'__params__' and a '__mesh__' beside it")
    from .sharding import block_index, state_cuts

    sizes = _mesh_sizes(mesh)
    coords = {a: mesh.get_local_rank(a) for a in sizes}

    def walk(t, ps, ss):
        if isinstance(t, dict):
            return {k: walk(v, ps[k], ss[k]) for k, v in t.items()}
        cuts = state_cuts(ps, ss, sizes)
        if not cuts:
            return None
        return StateCut(tuple(
            (d, *block_index(live, sizes, coords),
             tuple(mesh.get_group(a) for a in live)) for d, live in cuts))

    return walk(params, weights, opt)

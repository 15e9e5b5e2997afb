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
the live ``DeviceMesh`` the expert-parallel MoE layer reads, and
``"__fsdp__"``) are read with :func:`policy_value`.

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
The cut is made by the weights, so the hint passes either.  Still open:
the channel cut of the SSM and hybrid residual (``P(dp, None,
"model")``) and the encoder-decoder's cuts, which pass through.

A layer knows that it is tensor-parallel from its weights' shapes, never
from a flag.  Its products with weights cut on their output columns take
:func:`column_in` of their input, and its products with weights cut on
their input rows end with :func:`row_parallel_end`, which sums the
ranks' partial sums over ``model`` (Megatron's f and g).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass
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
    """How a pass's tokens lie over the live mesh: the sequence of length
    ``S`` cut into ``n`` blocks over the ``model`` group (``n == 1``: not
    cut, every ``model`` rank holds it whole), this rank's block
    ``rank``; the batch rows cut over the ``data`` group (``None`` where
    the mesh's data axis has one rank)."""

    S: int
    n: int
    rank: int
    model: object
    data: object
    n_data: int

    @property
    def cut(self) -> bool:
        return self.n > 1

    def _whole(self, t, dim: int) -> bool:
        """Whether ``t`` holds the whole sequence along ``dim`` (else this
        rank's block of it); any other length is a layout fault."""
        if t.shape[dim] not in (self.S, self.S // self.n):
            raise ValueError(
                f"a tensor of {t.shape[dim]} positions along dim {dim} in "
                f"a pass over {self.S} cut in {self.n} blocks: neither the "
                f"whole sequence nor a block of it")
        return t.shape[dim] == self.S

    def block(self, t, dim: int = 1):
        """This rank's block of a whole ``t`` along ``dim`` (a block
        passes)."""
        if not self.cut or not self._whole(t, dim):
            return t
        b = self.S // self.n
        return t.narrow(dim, self.rank * b, b)

    def gather(self, t):
        """The whole sequence from this rank's block of it (dim 1; a whole
        one passes)."""
        if not self.cut or self._whole(t, 1):
            return t
        from .collectives import all_gather_dim
        return all_gather_dim(t, 1, self.model)

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
        """``t`` of the rank holding the last block, in every rank of the
        ``model`` group (a broadcast from it)."""
        if not self.cut:
            return t
        import torch.distributed as dist
        t = t.contiguous()
        dist.broadcast(t, src=dist.get_global_rank(self.model, self.n - 1),
                       group=self.model)
        return t


def _sequence_split(S: int, cut: bool) -> Optional[Split]:
    """The :class:`Split` of a pass over ``S`` tokens a row under the
    policy in force: ``None`` without a ``"__mesh__"``; the sequence cut
    over ``model`` where ``cut`` and the policy's ``"residual"`` cuts dim
    1 over ``model``, ``model`` has more than one rank and divides ``S``."""
    mesh = policy_value("__mesh__")
    if mesh is None:
        return None
    import torch.distributed as dist
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    n, rank, model = 1, 0, None
    if "model" in names:
        spec = policy_value("residual")
        n_model = mesh.size(names.index("model"))
        if (cut and spec is not None and len(spec) > 1
                and "model" in _names(spec[1]) and n_model > 1
                and S % n_model == 0):
            model = mesh.get_group("model")
            n, rank = n_model, dist.get_rank(model)
    data, n_data = None, 1
    if "data" in names and mesh.size(names.index("data")) > 1:
        data = mesh.get_group("data")
        n_data = mesh.size(names.index("data"))
    return Split(S, n, rank, model, data, n_data)


def current_split() -> Optional[Split]:
    """The split of the pass in flight (:func:`split_sequence`), if any."""
    return getattr(_LOCAL, "split", None)


@contextmanager
def split_sequence(S: int, cut: bool = True):
    """Declare a pass over a whole sequence of ``S`` tokens a row: yields
    its :class:`Split` (``None`` without a mesh) and holds it for
    the hints until the pass ends."""
    old = current_split()
    _LOCAL.split = _sequence_split(S, cut)
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
    the router, ``lm_head``): under a sequence cut the whole sequence
    (the ``"block_in"`` gather; a whole ``h`` passes), whose gradient is
    reduce-scattered -- each rank's share summed; otherwise ``h`` itself,
    whose gradient is summed over ``model`` in the backward."""
    split = current_split()
    if split is not None and split.cut:
        return split.gather(h)
    from .collectives import summed_grads
    return summed_grads(h, (model_axis()[0],))


def row_parallel_end(t):
    """The end of a product whose weight is cut on its input rows over
    ``model`` (``wo``, ``w_down``, the vocabulary-parallel embedding, the
    expert-cut combine): ``t`` holds this rank's partial sums over the
    whole sequence.  Under a sequence cut their sum is reduce-scattered
    into this rank's block (what :func:`residual_block` takes of a whole
    output); otherwise (decode, a sequence that ``model`` does not divide)
    all-reduced.  Summed in float32, returned in ``t``'s dtype."""
    from .collectives import all_reduce_sum, reduce_scatter_dim
    group = model_axis()[0]
    split = current_split()
    if split is not None and split.cut:
        if not split._whole(t, 1):
            raise ValueError("a row-parallel product over a block of the "
                             "sequence: its input must be whole")
        return reduce_scatter_dim(t.float(), 1, group).to(t.dtype)
    return all_reduce_sum(t.float(), group).to(t.dtype)


def residual_block(t):
    """``t``'s block of the sequence where the pass in flight cuts it and
    ``t`` is whole, else ``t``: what the residual add takes of an output
    computed over the whole sequence.  Not a hint: no spec is read."""
    split = current_split()
    return t if split is None else split.block(t)


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
    if len(spec) > 1 and "model" in _names(spec[1]):
        return split.block(x)
    if all("model" not in _names(e) for e in spec):
        return split.gather(x)
    return x

"""Banked gather/scatter: the paper's bank-resolution circuit in front of a
bank-major table, as CUDA kernels with their plain torch versions.

The memory is stored *bank-major* -- physical layout ``(n_banks,
bank_volume, row_width)`` owned by a ``CompiledBankingPlan`` -- and the
kernels place every logical row by evaluating the bank-address /
bank-offset equations (Eq. 1-2) with the Sec-3.4 strength-reduced
arithmetic, **inside the kernel**, per row, in int32 registers: the
artifact's :meth:`~repro_torch.core.artifact.CompiledBankingPlan.kernel_program`
is packed into int32 words (``core.transforms.pack_kernel_program``, kept
on the artifact, and copied to each device once).  The library passes the
kernel a program that reduces to a short sum of terms of the address (the
server's page layouts) by value as that sum, another short LINEAR program
by value, decoded, and lets the kernel read any other from the device
(:func:`kernel_source`; ``csrc/banked.cu``), so one compiled library
serves every scheme and a layout swap between two decode ticks compiles
nothing.  No host-side bank/offset table feeds a gather or a scatter.

Three kernels, one wrapper each; each replaces the Pallas TPU kernel of the
same name in the JAX package's ``kernels/banked_gather.py``:

* :func:`banked_gather` -- ``out[t, :] = table[BA(i_t), BO(i_t), :]``
* :func:`banked_scatter` -- ``table[BA(i_t), BO(i_t), :] = values[t, :]``
* :func:`banked_scatter_elems` -- ``table[BA(i_t), BO(i_t), c_t] = v_t``

A wrapper launches its kernel when the table lies on a CUDA device (and
raises if the build, the arguments or the launch are not right -- nothing
falls back), and takes the ``*_plain`` version beside it only because the
table lies on the CPU.  ``LAUNCHES`` counts kernel launches per wrapper,
nothing else.

Both scatters update the table **in place** and return it (the TPU versions
donate the input buffer).  Duplicate addresses resolve **last write wins in
index order**.  :func:`banked_scatter` picks the winner of each address in
O(1) expected work a write, in blocks that each own a share of the
addresses: a shared-memory hash per block, or, for a block that owns more
than 1024 writes, a winner table in device memory -- ``4 * logical_size``
bytes, one int32 a logical address, allocated zeroed by the first call of
more than 1024 writes on a device and kept on the artifact; each launch
leaves it zero.  Nothing is allocated per call.
:func:`banked_scatter_elems` settles the writes to one ``(address,
column)`` pair within one warp by a match (up to 32 writes, the decode
tick), in one block of a thread a write by the match and a shared-memory
hash (up to 128, a flush after short prompts) or, past that, in the one
block that owns the pair (:func:`pair_owner`) by a shared-memory hash, in
windows of 1024 writes where a block owns more; it needs no memory beside
the table.  Either
scatter takes at most ``SCATTER_MAX_T`` writes per call.

The kernels do not trust an index they cannot resolve: a logical address
outside ``[0, logical_size)`` gathers a zero row, and a scatter to it (or to
a column outside the row) is dropped.  Index arrays that arrive on the host
(numpy, lists, CPU tensors) are range-checked before they are copied over
and raise ``IndexError``; indices that already lie on the card are not
inspected, since that would synchronize.  The plain versions raise on any
index out of range.

Use ``artifact.gather(table, rows)`` / ``artifact.scatter(...)`` rather
than binding these directly.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from ..core.transforms import (KERNEL_BUCKETS, KERNEL_TERMS_WORDS,
                               kernel_program_words, pack_kernel_program)

LAUNCHES: Dict[str, int] = {
    "banked_gather": 0, "banked_scatter": 0, "banked_scatter_elems": 0}
# B2's launches by path (:func:`elems_path`)
SCATTER_ELEMS_PATHS: Dict[str, int] = {"warp": 0, "block": 0, "blocks": 0}

# Every block of B2 and B3 reads all T indices.
SCATTER_MAX_T = 1 << 16

# B2's split of the pairs among blocks (``csrc/banked.cu``: BK_ELEM_*,
# bk_elem_blocks, bk_pair_owner), twinned here for the tests.
ELEMS_WARP = 32           # writes one warp settles by a match
ELEMS_PER_BLOCK = 128     # up to it one block, a thread a write; past
                          # it, the writes a block owns, about
ELEMS_ONE_HASH_BITS = 8   # the one block's hash of pairs
ELEMS_MAX_BLOCKS = 132    # one wave
ELEMS_OWN = 1024          # writes a block lists at once
ELEMS_HASH_BITS = 11      # its hash of pairs

_INT32_MAX = (1 << 31) - 1
_ELEMENT_SIZES = (1, 2, 4, 8)


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, SCATTER_ELEMS_PATHS):
        for k in counts:
            counts[k] = 0


def elems_path(T: int) -> str:
    """How B2 settles ``T`` writes: ``"warp"``, one warp's match (up to
    32); ``"block"``, one block of a thread a write, the warps' last
    writes claiming their pairs in a hash of 2^ELEMS_ONE_HASH_BITS slots
    (up to ``ELEMS_PER_BLOCK``); ``"blocks"``, blocks that own the pairs."""
    return ("warp" if T <= ELEMS_WARP else
            "block" if T <= ELEMS_PER_BLOCK else "blocks")


def elems_blocks(T: int) -> int:
    """Blocks of B2's launch for ``T`` writes (one up to
    ``ELEMS_PER_BLOCK``)."""
    return min(max(1, -(-T // ELEMS_PER_BLOCK)), ELEMS_MAX_BLOCKS)


def _pair_low_bits(keys) -> np.ndarray:
    return np.asarray(keys, np.int64).astype(np.uint64) & np.uint64(
        0xFFFFFFFF)


def pair_owner(keys, nb: int) -> np.ndarray:
    """The block of ``nb`` that owns each pair key (``address * D +
    column``) in B2: a multiplicative hash of the key's low 32 bits scaled
    to ``nb``."""
    h = (_pair_low_bits(keys) * np.uint64(2654435761)) & np.uint64(0xFFFFFFFF)
    return ((h * np.uint64(nb)) >> np.uint64(32)).astype(np.int64)


def pair_slot(keys, bits: int = ELEMS_HASH_BITS) -> np.ndarray:
    """Where each pair key starts probing B2's shared-memory hash of
    2^bits slots."""
    h = (_pair_low_bits(keys) * np.uint64(0x85EBCA77)) & np.uint64(0xFFFFFFFF)
    return (h >> np.uint64(32 - bits)).astype(np.int64)


# ---------------------------------------------------------------------------
# What the kernels read beside the table: the packed program, and B3's
# winner table, both kept on the artifact per device
# ---------------------------------------------------------------------------


def program_words(art) -> np.ndarray:
    """The artifact's kernel program packed as the kernels read it (int32
    words, :func:`~repro_torch.core.transforms.pack_kernel_program`),
    packed once and kept on the artifact."""
    cached = getattr(art, "_bk_words", None)
    if cached is not None:
        return cached
    layout = art.layout
    if layout.logical_size > _INT32_MAX or \
            layout.n_banks * layout.bank_volume > _INT32_MAX:
        raise ValueError("the banked kernels address rows in int32; layout "
                         f"{layout} is too large")
    fold = art.geometry.Ns if art.kind == "multidim" else (1,)
    words = pack_kernel_program(art.kernel_program(), layout.dims, fold,
                                layout.logical_size, layout.bank_volume)
    art._bk_words = words
    return words


def kernel_source(art) -> str:
    """How the kernels take the artifact's program (``csrc/banked.cu``,
    ``bk_with_program``): ``BkTerms<k>`` -- its sum of k terms
    (:func:`~repro_torch.core.transforms.kernel_terms`), by value -- where
    the host found one; else ``BkDev<registers,slots>`` of its bucket,
    read from device memory."""
    w = program_words(art)
    cap = int(w[7])
    terms = int(w[kernel_program_words(cap) - KERNEL_TERMS_WORDS])
    if terms:
        return f"BkTerms<{terms}>"
    return f"BkDev<{dict(KERNEL_BUCKETS)[cap]},{cap}>"


def _program_args(art, device):
    """Host and device addresses of the packed program (copied to
    ``device`` once and kept on the artifact): the library reads the host
    copy to choose the kernel and passes a sum of terms by value; the
    kernels read any other program from the device."""
    words = program_words(art)
    per_device = art.__dict__.setdefault("_bk_device_words", {})
    on_device = per_device.get(device)
    if on_device is None:
        on_device = per_device[device] = torch.from_numpy(words).to(device)
    return words.ctypes.data, on_device.data_ptr()


def _winner_table(art, device) -> torch.Tensor:
    """B3's winner table on ``device``: ``logical_size`` int32, zeroed once
    and kept on the artifact; a launch that uses it zeroes what it used."""
    per_device = art.__dict__.setdefault("_bk_winners", {})
    table = per_device.get(device)
    if table is None:
        table = per_device[device] = torch.zeros(
            art.layout.logical_size, dtype=torch.int32, device=device)
    return table


_lib = None


def _bind(lib) -> None:
    """Argument and result types, and the check that the library reads the
    program this module packs: once, under the build lock."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.bk_program_words.argtypes = [i32]
    lib.bk_block_writes.argtypes = []
    lib.bk_gather.argtypes = [ptr, ptr, ptr, i32, i32, ptr, ptr, ptr]
    lib.bk_scatter_rows.argtypes = [ptr, ptr, ptr, i32, i32, ptr, ptr,
                                    ptr, ptr]
    lib.bk_scatter_elems.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32,
                                     ptr, ptr, ptr]
    lib.bk_elems_blocks.argtypes = [i32]
    lib.bk_elems_owner.argtypes = [ctypes.c_longlong, i32]
    for fn in (lib.bk_program_words, lib.bk_block_writes, lib.bk_gather,
               lib.bk_scatter_rows, lib.bk_scatter_elems,
               lib.bk_elems_blocks, lib.bk_elems_owner):
        fn.restype = ctypes.c_int
    for cap, _ in KERNEL_BUCKETS:
        if lib.bk_program_words(cap) != kernel_program_words(cap):
            raise RuntimeError(
                f"banked.cu reads a program of {cap} instructions from "
                f"{lib.bk_program_words(cap)} words, the wrapper packs "
                f"{kernel_program_words(cap)}")


def _library():
    """The compiled kernels, built at first use; raises when they cannot
    be built or do not read the program this module packs."""
    global _lib
    if _lib is None:
        from . import _build

        _lib = _build.load("banked", _bind)
    return _lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# Argument checking shared by the kernels and their plain versions
# ---------------------------------------------------------------------------


def as_index(idx, device, limit: int, what: str = "indices") -> torch.Tensor:
    """Index data -> contiguous int32 tensor on ``device``.

    Host data (numpy, lists, CPU tensors) is checked against
    ``[0, limit)`` here, where that costs no device synchronization; a
    tensor that already lies on a CUDA device is only converted."""
    if isinstance(idx, torch.Tensor) and idx.is_cuda:
        if idx.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"{what} must be int32 or int64, got {idx.dtype}")
        return idx.to(device=device, dtype=torch.int32).contiguous()
    host = idx.numpy() if isinstance(idx, torch.Tensor) else np.asarray(idx)
    if host.size and not np.issubdtype(host.dtype, np.integer):
        raise TypeError(f"{what} must be integers, got {host.dtype}")
    if host.size and (host.min() < 0 or host.max() >= limit):
        raise IndexError(f"{what} out of range [0, {limit}): "
                         f"min {host.min()}, max {host.max()}")
    return torch.from_numpy(
        np.ascontiguousarray(host, dtype=np.int32)).to(device)


def _check_table(table, art) -> None:
    if not isinstance(table, torch.Tensor):
        raise TypeError(f"table must be a torch.Tensor, "
                        f"got {type(table).__name__}")
    if table.ndim != 3 or tuple(table.shape[:2]) != (art.n_banks,
                                                     art.bank_volume):
        raise ValueError(
            f"table shape {tuple(table.shape)} does not match the layout's "
            f"bank-major {art.layout.table_shape(-1)[:2]} + (D,)")
    if not table.is_contiguous():
        raise ValueError("table must be contiguous")
    if table.is_cuda and table.element_size() not in _ELEMENT_SIZES:
        raise TypeError(f"unsupported element size of {table.dtype}")


def _as_values(values, table, shape) -> torch.Tensor:
    values = torch.as_tensor(values).to(device=table.device,
                                        dtype=table.dtype).contiguous()
    if tuple(values.shape) != tuple(shape):
        raise ValueError(f"values have shape {tuple(values.shape)}, "
                         f"expected {tuple(shape)}")
    return values


def _check_scatter_size(T: int) -> None:
    if T > SCATTER_MAX_T:
        raise ValueError(
            f"a banked scatter takes at most {SCATTER_MAX_T} writes per "
            f"call, got {T}")


# ---------------------------------------------------------------------------
# B1: gather
# ---------------------------------------------------------------------------


def banked_gather_plain(table: torch.Tensor, indices: torch.Tensor,
                        art) -> torch.Tensor:
    """Plain torch version of :func:`banked_gather`: resolve through the
    artifact's ``lower_torch`` callables, then advanced indexing."""
    ba, bo = art.resolve(indices.to(torch.int64))
    return table[ba, bo]


def banked_gather(table: torch.Tensor, indices, art) -> torch.Tensor:
    """table: ``(n_banks, bank_volume, D)`` bank-major storage;
    indices: ``(T,)`` flat logical addresses.  Returns ``(T, D)`` rows.

    On a CUDA table: one launch of ``bk_gather`` -- the lanes that cover a
    row's 16-byte pieces (at most a warp) each evaluate its BA/BO from the
    artifact's packed program and copy their pieces."""
    _check_table(table, art)
    idx = as_index(indices, table.device, art.layout.logical_size)
    if idx.ndim != 1:
        raise ValueError(f"indices must be (T,), got {tuple(idx.shape)}")
    if not table.is_cuda:
        return banked_gather_plain(table, idx, art)
    T, D = idx.shape[0], table.shape[2]
    out = torch.empty((T, D), dtype=table.dtype, device=table.device)
    lib = _library()
    with torch.cuda.device(table.device):
        err = lib.bk_gather(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), T,
            D * table.element_size(), *_program_args(art, table.device),
            _stream(table.device))
    _check(err, "banked_gather")
    LAUNCHES["banked_gather"] += 1
    return out


# ---------------------------------------------------------------------------
# B3: scatter of whole rows
# ---------------------------------------------------------------------------


def _last_occurrence(keys: torch.Tensor) -> torch.Tensor:
    """Positions t such that no later t' > t has ``keys[t'] == keys[t]``
    (loop-free: a stable sort groups equal keys in index order)."""
    order = torch.sort(keys, stable=True).indices
    sorted_keys = keys[order]
    last = torch.ones_like(sorted_keys, dtype=torch.bool)
    last[:-1] = sorted_keys[1:] != sorted_keys[:-1]
    return order[last]


def banked_scatter_plain(table: torch.Tensor, indices: torch.Tensor,
                         values: torch.Tensor, art) -> torch.Tensor:
    """Plain torch version of :func:`banked_scatter` (in place): keep the
    last occurrence of every address, then one indexed assignment."""
    idx = indices.to(torch.int64)
    keep = _last_occurrence(idx)
    ba, bo = art.resolve(idx[keep])
    table[ba, bo] = values[keep]
    return table


def banked_scatter(table: torch.Tensor, indices, values, art) -> torch.Tensor:
    """Write rows into bank-major storage, in place; returns ``table``.

    table: ``(n_banks, bank_volume, D)``; indices: ``(T,)`` flat logical
    addresses; values: ``(T, D)`` replacement rows (cast to the table's
    dtype).  Untouched slots carry over; duplicates resolve last write
    wins in index order.  On a CUDA table: one launch of
    ``bk_scatter_rows_kernel`` (with the artifact's winner table on that
    device past 1024 writes)."""
    _check_table(table, art)
    idx = as_index(indices, table.device, art.layout.logical_size)
    if idx.ndim != 1:
        raise ValueError(f"indices must be (T,), got {tuple(idx.shape)}")
    T, D = idx.shape[0], table.shape[2]
    values = _as_values(values, table, (T, D))
    _check_scatter_size(T)
    if not table.is_cuda:
        return banked_scatter_plain(table, idx, values, art)
    lib = _library()
    win = (_winner_table(art, table.device).data_ptr()
           if T > lib.bk_block_writes() else None)
    with torch.cuda.device(table.device):
        err = lib.bk_scatter_rows(
            table.data_ptr(), idx.data_ptr(), values.data_ptr(), T,
            D * table.element_size(), *_program_args(art, table.device),
            win, _stream(table.device))
    _check(err, "banked_scatter")
    LAUNCHES["banked_scatter"] += 1
    return table


# ---------------------------------------------------------------------------
# B2: scatter of single elements
# ---------------------------------------------------------------------------


def banked_scatter_elems_plain(table: torch.Tensor, indices: torch.Tensor,
                               cols: torch.Tensor, values: torch.Tensor,
                               art) -> torch.Tensor:
    """Plain torch version of :func:`banked_scatter_elems` (in place)."""
    idx = indices.to(torch.int64)
    cols = cols.to(torch.int64)
    D = table.shape[2]
    if cols.numel() and (int(cols.min()) < 0 or int(cols.max()) >= D):
        raise IndexError(f"columns out of range [0, {D})")
    keep = _last_occurrence(idx * D + cols)
    ba, bo = art.resolve(idx[keep])
    table[ba, bo, cols[keep]] = values[keep]
    return table


def banked_scatter_elems(table: torch.Tensor, indices, cols, values,
                         art) -> torch.Tensor:
    """Scatter single elements, in place:
    ``table[ba(i_t), bo(i_t), cols[t]] = values[t]``; returns ``table``.

    A batch of per-slot token-record writes (the serving runtime's decode
    tick, or the records of freshly admitted prompts) lands in ONE kernel
    launch without read-modify-writing whole rows.  Same in-place /
    last-write-wins semantics as :func:`banked_scatter`, per ``(address,
    column)`` pair.  On a CUDA table: one launch of
    ``bk_scatter_elems_kernel`` by :func:`elems_path`: one warp up to 32
    writes, one block up to ``ELEMS_PER_BLOCK``, else :func:`elems_blocks`
    blocks that each own a share of the pairs."""
    _check_table(table, art)
    idx = as_index(indices, table.device, art.layout.logical_size)
    col = as_index(cols, table.device, table.shape[2], "columns")
    if idx.ndim != 1 or col.shape != idx.shape:
        raise ValueError(f"indices {tuple(idx.shape)} and columns "
                         f"{tuple(col.shape)} must both be (T,)")
    T, D = idx.shape[0], table.shape[2]
    values = _as_values(values, table, (T,))
    _check_scatter_size(T)
    if not table.is_cuda:
        return banked_scatter_elems_plain(table, idx, col, values, art)
    lib = _library()
    with torch.cuda.device(table.device):
        err = lib.bk_scatter_elems(
            table.data_ptr(), idx.data_ptr(), col.data_ptr(),
            values.data_ptr(), T, D, table.element_size(),
            *_program_args(art, table.device), _stream(table.device))
    _check(err, "banked_scatter_elems")
    LAUNCHES["banked_scatter_elems"] += 1
    SCATTER_ELEMS_PATHS[elems_path(T)] += 1
    return table

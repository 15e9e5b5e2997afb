"""Banked gather/scatter: the paper's bank-resolution circuit in front of a
bank-major table, as CUDA kernels with their plain torch versions.

The memory is stored *bank-major* -- physical layout ``(n_banks,
bank_volume, row_width)`` owned by a ``CompiledBankingPlan`` -- and the
kernels place every logical row by evaluating the bank-address /
bank-offset equations (Eq. 1-2) with the Sec-3.4 strength-reduced
arithmetic, **inside the kernel**, per row, in int32 registers: the
artifact's :meth:`~repro_torch.core.artifact.CompiledBankingPlan.kernel_program`
is handed to the launch by value (``csrc/banked.cu``), so one compiled
library serves every scheme and a layout swap between two decode ticks
compiles nothing.  No host-side bank/offset table feeds a gather or a
scatter.

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
index order**: the kernels drop a write when a later one carries the same
logical address (and column), which reads O(T^2) indices, so a scatter takes
at most ``SCATTER_MAX_T`` writes per call.

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

from ..core.transforms import (KERNEL_MAX_DIMS, KERNEL_MAX_INSTRS,
                               KernelProgram)

LAUNCHES: Dict[str, int] = {
    "banked_gather": 0, "banked_scatter": 0, "banked_scatter_elems": 0}

SCATTER_MAX_T = 1 << 16     # the duplicate check is O(T^2) index reads

_INT32_MAX = (1 << 31) - 1
_ELEMENT_SIZES = (1, 2, 4, 8)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# The program struct of csrc/banked.cu, field for field
# ---------------------------------------------------------------------------


class _BkInstr(ctypes.Structure):
    _fields_ = [("op", ctypes.c_uint8), ("dst", ctypes.c_uint8),
                ("a", ctypes.c_uint8), ("b", ctypes.c_uint8),
                ("imm", ctypes.c_int32)]


class _BkProgram(ctypes.Structure):
    _fields_ = [("n_dims", ctypes.c_int32), ("n_instrs", ctypes.c_int32),
                ("n_ba", ctypes.c_int32), ("bo_reg", ctypes.c_int32),
                ("logical_size", ctypes.c_int32),
                ("bank_volume", ctypes.c_int32),
                ("dims", ctypes.c_int32 * KERNEL_MAX_DIMS),
                ("ba_regs", ctypes.c_int32 * KERNEL_MAX_DIMS),
                ("ba_fold", ctypes.c_int32 * KERNEL_MAX_DIMS),
                ("instrs", _BkInstr * KERNEL_MAX_INSTRS)]


def _program_struct(art) -> _BkProgram:
    """The artifact's kernel program, packed once and kept on it."""
    cached = getattr(art, "_bk_program", None)
    if cached is not None:
        return cached
    prog: KernelProgram = art.kernel_program()
    layout = art.layout
    if layout.logical_size > _INT32_MAX or \
            layout.n_banks * layout.bank_volume > _INT32_MAX:
        raise ValueError("the banked kernels address rows in int32; layout "
                         f"{layout} is too large")
    p = _BkProgram()
    p.n_dims = len(layout.dims)
    p.n_instrs = len(prog.instrs)
    p.n_ba = len(prog.ba_regs)
    p.bo_reg = prog.bo_reg
    p.logical_size = layout.logical_size
    p.bank_volume = layout.bank_volume
    for i, d in enumerate(layout.dims):
        p.dims[i] = d
    fold = art.geometry.Ns if art.kind == "multidim" else (1,)
    for k, (reg, n) in enumerate(zip(prog.ba_regs, fold)):
        p.ba_regs[k] = reg
        p.ba_fold[k] = n
    for i, (op, dst, a, b, imm) in enumerate(prog.instrs):
        p.instrs[i] = _BkInstr(op, dst, a, b, imm)
    art._bk_program = p
    return p


_lib = None


def _library():
    """The compiled kernels, built at first use; raises when they cannot
    be built or do not match this module's program struct."""
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("banked")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.bk_program_bytes.argtypes = []
        lib.bk_program_bytes.restype = ctypes.c_int
        lib.bk_gather.argtypes = [ptr, ptr, ptr, i32, i32, ptr, ptr]
        lib.bk_scatter_rows.argtypes = [ptr, ptr, ptr, i32, i32, ptr, ptr]
        lib.bk_scatter_elems.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32,
                                         ptr, ptr]
        for fn in (lib.bk_gather, lib.bk_scatter_rows, lib.bk_scatter_elems):
            fn.restype = ctypes.c_int
        if lib.bk_program_bytes() != ctypes.sizeof(_BkProgram):
            raise RuntimeError(
                f"banked.cu holds a {lib.bk_program_bytes()}-byte program, "
                f"the wrapper packs {ctypes.sizeof(_BkProgram)} bytes")
        _lib = lib
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
            f"a banked scatter takes at most {SCATTER_MAX_T} writes per call "
            f"(its duplicate check reads O(T^2) indices), got {T}")


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

    On a CUDA table: one launch of ``bk_gather`` -- a warp per row, BA/BO
    evaluated by the warp's first lane from the artifact's kernel program,
    the row copied in up to 16-byte pieces."""
    _check_table(table, art)
    idx = as_index(indices, table.device, art.layout.logical_size)
    if idx.ndim != 1:
        raise ValueError(f"indices must be (T,), got {tuple(idx.shape)}")
    if not table.is_cuda:
        return banked_gather_plain(table, idx, art)
    T, D = idx.shape[0], table.shape[2]
    out = torch.empty((T, D), dtype=table.dtype, device=table.device)
    lib, prog = _library(), _program_struct(art)
    with torch.cuda.device(table.device):
        err = lib.bk_gather(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), T,
            D * table.element_size(), ctypes.addressof(prog),
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
    wins in index order."""
    _check_table(table, art)
    idx = as_index(indices, table.device, art.layout.logical_size)
    if idx.ndim != 1:
        raise ValueError(f"indices must be (T,), got {tuple(idx.shape)}")
    T, D = idx.shape[0], table.shape[2]
    values = _as_values(values, table, (T, D))
    _check_scatter_size(T)
    if not table.is_cuda:
        return banked_scatter_plain(table, idx, values, art)
    lib, prog = _library(), _program_struct(art)
    with torch.cuda.device(table.device):
        err = lib.bk_scatter_rows(
            table.data_ptr(), idx.data_ptr(), values.data_ptr(), T,
            D * table.element_size(), ctypes.addressof(prog),
            _stream(table.device))
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
    tick) lands in ONE kernel launch without read-modify-writing whole
    rows.  Same in-place / last-write-wins semantics as
    :func:`banked_scatter`, per ``(address, column)`` pair."""
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
    lib, prog = _library(), _program_struct(art)
    with torch.cuda.device(table.device):
        err = lib.bk_scatter_elems(
            table.data_ptr(), idx.data_ptr(), col.data_ptr(),
            values.data_ptr(), T, D, table.element_size(),
            ctypes.addressof(prog), _stream(table.device))
    _check(err, "banked_scatter_elems")
    LAUNCHES["banked_scatter_elems"] += 1
    return table

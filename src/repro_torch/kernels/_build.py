"""Build and load the package's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes`` -- no
PyTorch headers, so a build takes seconds.  Libraries are built at first
use into ``build/`` at the root of the checkout, under a name that carries
a hash of the source, the headers under ``csrc/`` and the flags, so an
edited source or header is never served by a stale library.
Nothing here runs when the package is imported; a failed build raises.

Building and loading run under one module lock, so threads of one process
that reach a cold ``build/`` together (the servers of a fleet) start one
``nvcc`` per source and load one library; a temporary file is named by the
process and the thread, so processes sharing ``build/`` never write into
each other's output either.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

SOURCES = {"banked": "banked.cu", "moe_dispatch": "moe_dispatch.cu",
           "ssd_chunk": "ssd_chunk.cu",
           "flash_attention": "flash_attention.cu",
           "decode_attention": "decode_attention.cu"}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.RLock()               # build and load, one thread at a time
build_seconds: Dict[str, float] = {}    # name -> wall time of its last build
build_log: Dict[str, str] = {}          # name -> what nvcc printed then


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build"


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            cands.append(os.path.join(os.environ[var], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of repro_torch cannot be built on this machine")


def _lib_path(name: str) -> Path:
    """The library's path, named by a hash of its source, every header
    under ``csrc/`` (a source may include any of them) and the flags."""
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None, *, force: bool = False,
          extra_flags: Iterable[str] = ()) -> Dict[str, Path]:
    """Compile the named sources (default: all), one ``nvcc`` process each,
    all started together.  An up-to-date library is kept unless ``force``.
    Returns name -> library path; raises with the compiler's output when a
    build fails."""
    with _LOCK:
        return _build(names, force, extra_flags)


def _build(names, force, extra_flags) -> Dict[str, Path]:
    names = list(SOURCES) if names is None else list(names)
    out = {n: _lib_path(n) for n in names}
    todo = [n for n in names if force or not out[n].exists()]
    if not todo:
        return out
    nvcc = find_nvcc()
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = out[n].with_suffix(
            f".tmp{os.getpid()}-{threading.get_ident()}.so")
        cmd = [nvcc, *NVCC_FLAGS, *extra_flags, "-o", str(tmp),
               str(CSRC / SOURCES[n])]
        procs[n] = (time.perf_counter(), tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for n, (t0, tmp, cmd, proc) in procs.items():
        log, _ = proc.communicate()
        build_seconds[n] = time.perf_counter() - t0
        build_log[n] = log
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {SOURCES[n]} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{log}")
        os.replace(tmp, out[n])
        _LIBS.pop(n, None)
    return out


def load(name: str, bind: Optional[Callable[[ctypes.CDLL], None]] = None
         ) -> ctypes.CDLL:
    """The loaded library of one source, built first when needed.  ``bind``
    (the wrapper's argument and result types, its checks) runs once, on the
    first load, before any thread is handed the library."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            if bind is not None:
                bind(lib)
            _LIBS[name] = lib
        return lib

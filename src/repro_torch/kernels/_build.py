"""Build and load the package's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes`` -- no
PyTorch headers, so a build takes seconds.  Libraries are built at first
use into ``build/`` at the root of the checkout, under a name that carries
a hash of the source and the flags, so an edited source is never served by a stale library.
Nothing here runs when the package is imported; a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

SOURCES = {"banked": "banked.cu", "moe_dispatch": "moe_dispatch.cu"}

_LIBS: Dict[str, ctypes.CDLL] = {}
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
    src = CSRC / SOURCES[name]
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None, *, force: bool = False,
          extra_flags: Iterable[str] = ()) -> Dict[str, Path]:
    """Compile the named sources (default: all), one ``nvcc`` process each,
    all started together.  An up-to-date library is kept unless ``force``.
    Returns name -> library path; raises with the compiler's output when a
    build fails."""
    names = list(SOURCES) if names is None else list(names)
    out = {n: _lib_path(n) for n in names}
    todo = [n for n in names if force or not out[n].exists()]
    if not todo:
        return out
    nvcc = find_nvcc()
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = out[n].with_suffix(f".tmp{os.getpid()}.so")
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


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first when needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(build([name])[name]))
    return lib

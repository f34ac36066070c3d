"""Build and load the port's hand-written CUDA kernels.

Each source under ``bigdl_tpu_torch/csrc/`` has a plain C interface.  It is
compiled with ``nvcc`` for ``sm_90a`` into its own shared library and loaded
with ``ctypes``.  Nothing is built when a module is imported: the first
launch of a kernel calls :func:`load`, which builds every source (one
``nvcc`` process per source, all started together) into ``build/kernels/``
next to the package, keyed by a hash of the source and the flags, and
reuses a library that is already there.  A failed build raises
:class:`KernelBuildError`; there is no fallback.

Flags: ``-O3`` and ``-Xptxas -v`` (register, shared-memory and spill
report, kept in :data:`ptxas_report`).  Never ``--use_fast_math``: the
int8 GEMM's epilogue relies on IEEE division and a single-rounding FMA,
the LSTM cell's gates on the accurate ``expf``/``tanhf``, the max-pool
backward on IEEE adds in the reference's order, and the embedding bag on
``__fmaf_rn`` in the reference's order.
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
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

# library name -> source file under csrc/
SOURCES = {"int8_gemm": "int8_gemm.cu", "lstm_cell": "lstm_cell.cu",
           "maxpool_bwd": "maxpool_bwd.cu", "embed_bag": "embed_bag.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: library name -> the ``-Xptxas -v`` lines of its build (empty when the
#: library was already built)
ptxas_report: Dict[str, str] = {}
#: seconds the last :func:`load` spent building (0.0 when nothing was built)
build_seconds = 0.0


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the port's CUDA kernels cannot be built")
    return found


def _target(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``; builds every missing library first."""
    global build_seconds
    with _lock:
        if name not in _libs:
            missing = [n for n in SOURCES if not _target(n).is_file()]
            if missing:
                t0 = time.monotonic()
                _build(missing)
                build_seconds = time.monotonic() - t0
            for n in SOURCES:
                if n not in _libs:
                    _libs[n] = ctypes.CDLL(str(_target(n)))
        return _libs[name]


def _build(names) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in names:
        tmp = _target(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{SOURCES[n]} (exit {proc.returncode}):\n{out}")
            continue
        ptxas_report[n] = "\n".join(
            line for line in out.splitlines() if "ptxas" in line)
        os.replace(tmp, _target(n))  # atomic: concurrent builders agree
    if failed:
        raise KernelBuildError("nvcc failed for " + "\n".join(failed))

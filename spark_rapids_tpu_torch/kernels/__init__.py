"""Build and bind the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ctypes: no PyTorch headers,
so a build takes seconds.  Libraries are built from the sources of the
checkout at first use, into ``build/kernels/`` beside the package, and are
named by a hash of their source and flags, so an edited source is rebuilt.
A failed build raises; nothing falls back to the plain PyTorch versions.
Nothing here runs at import time: the CPU tests import every module on a
host without ``nvcc``.
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
from typing import Dict, Iterable

__all__ = ["KERNELS", "BUILD_DIR", "build", "build_log", "load",
           "check_launch", "pointer_array", "int_array"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
KERNELS = ("masked_reduce", "grid_agg")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_SIGNATURES = {
    # active, n, k, data[], valid[], ops[], is_f64[], partials, nblocks,
    # acc_f, acc_i, stream
    "masked_reduce": [_P, ctypes.c_longlong, ctypes.c_int, _P, _P, _P, _P,
                      _P, ctypes.c_int, _P, _P, _P],
    # codes[], code_valid[], dims[], nkeys, active, n, f[], f_valid[], nf,
    # i[], i_valid[], ni, acc_f, acc_i, acc_cnt, G, use_shared, stream
    "grid_agg": [_P, _P, _P, ctypes.c_int, _P, ctypes.c_longlong, _P, _P,
                 ctypes.c_int, _P, _P, ctypes.c_int, _P, _P, _P,
                 ctypes.c_int, ctypes.c_int, _P],
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "spark_rapids_tpu_torch are built with the CUDA "
                           "toolkit on the machine with the card")
    return found


def _library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together.  Returns seconds per compiled kernel
    (empty when everything was built already); raises on a failed build.
    ``nvcc``'s output (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside each library as ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = _library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out, time.perf_counter())
    seconds, failures = {}, []
    for name, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".so.log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("kernel build failed: " + "\n".join(failures))
    return seconds


def build_log(name: str) -> str:
    """``nvcc``'s output for the current build of kernel ``name``."""
    log = _library_path(name).with_suffix(".so.log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The ctypes library of kernel ``name``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_library_path(name)))
            fn = getattr(lib, name)
            fn.argtypes = _SIGNATURES[name]
            fn.restype = ctypes.c_int
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check_launch(lib: ctypes.CDLL, name: str, rc: int) -> None:
    """Raise if a launch returned a CUDA error (the C entry returns
    ``cudaGetLastError()``)."""
    if rc != 0:
        msg = lib.cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({rc})")


def pointer_array(ptrs) -> ctypes.Array:
    """A host array of pointers (``None`` → nullptr) to pass where the C
    entry takes ``const void* const*``; the caller keeps it alive across
    the call."""
    return (ctypes.c_void_p * max(len(ptrs), 1))(*ptrs)


def int_array(vals) -> ctypes.Array:
    """A host array of C ints."""
    return (ctypes.c_int * max(len(vals), 1))(*vals)

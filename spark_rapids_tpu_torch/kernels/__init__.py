"""Build and bind the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ctypes: no PyTorch headers,
so a build takes seconds.  Libraries are built from the sources of the
checkout at first use, into ``build/kernels/`` beside the package, and are
named by a hash of their source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source or header is rebuilt.
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
           "check_launch", "pointer_array", "int_array", "int64_array"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
KERNELS = ("masked_reduce", "grid_agg", "dense_join", "dense_agg", "topk",
           "compact", "csr_join", "hash_agg", "hashing", "sort_join", "sort",
           "window_scan", "window_frame", "cond_join", "wide_decimal",
           "sample", "explode", "key_stats", "bucketize", "group_ratio")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double
# per kernel source: its C entry points and their ctypes argument types
_SIGNATURES = {
    "masked_reduce": {
        # active, n, k, data[], valid[], ops[], is_f64[], scratch,
        # scratch_blocks, acc_f, acc_i, acc_h, stream
        "masked_reduce": [_P, _L, _I, _P, _P, _P, _P, _P, _I, _P, _P, _P,
                          _P],
    },
    "grid_agg": {
        # codes[], code_valid[], dims[], nkeys, active, n, f[], f_valid[],
        # nf, i[], i_valid[], ni, acc_f, acc_i, acc_cnt, q, fb, words, call,
        # G, use_shared, stream
        "grid_agg": [_P, _P, _P, _I, _P, _L, _P, _P, _I, _P, _P, _I, _P, _P,
                     _P, _P, _P, _P, _L, _I, _I, _P],
        # q, acc_f, words, nf, cells, stream
        "grid_agg_fold": [_P, _P, _P, _I, _L, _P],
    },
    "dense_join": {
        # keys, elem, key_valid, active, n, cap, bitmap, out, stream
        "dense_join_stats": [_P, _I, _P, _P, _L, _L, _P, _P, _P],
        # keys, elem, key_valid, active, n, kmin, D, table, stream
        "dense_join_build": [_P, _I, _P, _P, _L, _L, _L, _P, _P],
        # keys, elem, key_valid, active, n, kmin, D, blk, status, ctr,
        # rows, list, cap, stream
        "dense_join_build_sparse": [_P, _I, _P, _P, _L, _L, _L, _P, _P, _P,
                                    _P, _P, _L, _P],
        # keys, elem, key_valid, active, n, kmin, D, table, blk, rows, mode,
        # ncols, data[], valid[], elems[], out[], out_valid[], out_sel,
        # stream
        "dense_join_probe": [_P, _I, _P, _P, _L, _L, _L, _P, _P, _P, _I, _I,
                             _P, _P, _P, _P, _P, _P, _P],
    },
    "csr_join": {
        # n, D
        "csr_build_scratch": [_L, _L],
        # keys, elem, key_valid, active, n, kmin, D, starts, b_perm,
        # scratch, scratch_bytes, stream
        "csr_build": [_P, _I, _P, _P, _L, _L, _L, _P, _P, _P, _L, _P],
        # in, n, out, sums, stream
        "csr_scan": [_P, _L, _P, _P, _P],
        # keys, elem, key_valid, active, n, kmin, D, starts, mode, lo, cnt,
        # sel, stream
        "csr_probe": [_P, _I, _P, _P, _L, _L, _L, _P, _I, _P, _P, _P, _P],
        # offsets, lo, b_perm, n, total, pi, bi, stream
        "csr_expand": [_P, _P, _P, _L, _L, _P, _P, _P],
        # idx, idx_elem, n, ncols, data[], valid[], elems[], out[],
        # out_valid[], stream
        "csr_gather": [_P, _I, _L, _I, _P, _P, _P, _P, _P, _P],
        # n, nparts
        "partition_perm_scratch": [_L, _L],
        # pids, n, nparts, perm, scratch, scratch_bytes, stream
        "partition_perm": [_P, _L, _L, _P, _P, _L, _P],
    },
    "hash_agg": {
        # nkeys, words[], kvalid[], nch, data[], valid[], ops[], f64[],
        # hot[], cold[], W, H, init[] (host), active, n, recs, stride, cap,
        # collide, meta, vals, ngroups, fwords, rgid, fbprev, fblist, call,
        # stream
        "hash_agg_update": [_I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                            _P, _P, _L, _P, _I, _L, _I, _P, _P, _P, _P, _P,
                            _P, _P, _L, _P],
        # nch, ops[], f64[], hot[], cold[], vals, W, ngroups, fwords, gbound,
        # stream
        "hash_agg_fold": [_I, _P, _P, _P, _P, _P, _I, _P, _P, _L, _P],
        # nkeys, recs, stride, cap, collide, meta, ngroups, gbound, stream
        "hash_agg_reinsert": [_I, _P, _I, _L, _I, _P, _P, _L, _P],
    },
    "dense_agg": {
        # nkeys, data[], valid[], elems[], cand[], active, n, stats, tables,
        # fd, stream
        "dense_agg_stats": [_I, _P, _P, _P, _P, _P, _L, _P, _P, _P, _P],
        # key, key_valid, key_elem, nres, res[], res_valid[], res_elem[],
        # res_f64[], res_off[], nch, ch[], ch_valid[], ch_op[], ch_f64[],
        # ch_off[], ch_q[], active, n, kmin, D, rec, R, state_off, present,
        # cap, ocount, obounds, okey, ores[], ores_valid[], och[],
        # och_valid[], fwords, work, stream
        "dense_agg_update": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P,
                             _P, _P, _P, _P, _P, _L, _L, _L, _P, _I, _I, _P,
                             _L, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
        # nres, res_off[], rec, R, state_off, present, S, nf, q_off[],
        # acc_off[], fwords, out, stream
        "dense_agg_check": [_I, _P, _P, _I, _I, _P, _L, _I, _P, _P, _P, _P,
                            _P],
    },
    "topk": {
        # nkeys, data[], valid[], kinds[], desc[], nulls_first[], active, n,
        # k, scratch, out, stream
        "topk": [_I, _P, _P, _P, _P, _P, _P, _L, _I, _P, _P, _P],
        # n, k, nwords
        "topk_scratch": [_L, _I, _I],
    },
    "hashing": {
        # nkeys, data[], valid[], elems[], is_float[], active, n, algo, seed,
        # nparts, magic, bias, hash_out, pid_out, counts, stream
        "hash_rows": [_I, _P, _P, _P, _P, _P, _L, _I, _L, _I, _L, _I, _P, _P,
                      _P, _P],
    },
    "sort_join": {
        # n, passes
        "sort_build_scratch": [_L, _I],
        # nkeys, data[], valid[], elems[], kinds[], active, n, words, b_perm,
        # n_valid, scratch, scratch_bytes, stream
        "sort_build": [_I, _P, _P, _P, _P, _P, _L, _P, _P, _P, _P, _L, _P],
        # nkeys, data[], valid[], elems[], kinds[], active, n, words, nb,
        # n_valid, mode, lo, matches, cnt, sel, stream
        "sort_probe": [_I, _P, _P, _P, _P, _P, _L, _P, _L, _P, _I, _P, _P, _P,
                       _P, _P],
        # lo, matches, n, b_perm, nb, active, hit, mask, count, stream
        "sort_unmatched": [_P, _P, _L, _P, _L, _P, _P, _P, _P, _P],
    },
    "sort": {
        # data, valid, elem, kind, desc, nulls_first, n, word, flag_word,
        # stream
        "sort_image": [_P, _P, _I, _I, _I, _I, _L, _P, _P, _P],
        # n, passes
        "sort_perm_scratch": [_L, _I],
        "sort_tile_rows": [],
        # nwords, words[], bytes[], active, n, perm, scratch, scratch_bytes,
        # stream
        "sort_perm": [_I, _P, _P, _P, _L, _P, _P, _L, _P],
        # data, valid, elem, kind, desc, nulls_first, perm, n, out, stream
        "sort_range_key": [_P, _P, _I, _I, _I, _I, _P, _L, _P, _P],
        # ncols, in[], out[], vin[], vout[], elems[], perm, n, stream
        "sort_gather": [_I, _P, _P, _P, _P, _P, _P, _L, _P],
    },
    "window_scan": {
        # n
        "win_scratch_bytes": [_L],
        # npart, nkeys, data[], valid[], elems[], kinds[], n, seg_start,
        # peer_start, seg_pos, seg_end, peer_pos, peer_end, scratch, stream
        "win_context": [_I, _I, _P, _P, _P, _P, _L, _P, _P, _P, _P, _P, _P,
                        _P, _P],
        # type, op, mode, vals, mask, flags, reset, identity_bits, n, out,
        # scratch, stream
        "win_scan": [_I, _I, _I, _P, _P, _P, _P, _L, _L, _P, _P, _P],
        # src, elem, idx, n, out, stream
        "win_take": [_P, _I, _P, _L, _P, _P],
        # fn, tiles, seg_start, seg_end, peer_start, peer_end, dense, n, out,
        # stream
        "win_rank": [_I, _L, _P, _P, _P, _P, _P, _L, _P, _P],
        # data, valid, elem, offset, dflt, dflt_valid, seg_start, seg_end, n,
        # out, out_valid, stream
        "win_shift": [_P, _P, _I, _L, _P, _P, _P, _P, _L, _P, _P, _P],
    },
    "window_frame": {
        # lo, hi, lo_unb, hi_unb, seg_start, seg_end, n, lo_out, hi_out,
        # stream
        "frame_rows": [_L, _L, _I, _I, _P, _P, _L, _P, _P, _P],
        # key, elem, valid, desc, nulls_first, lo, hi, lo_unb, hi_unb,
        # seg_start, seg_end, n, lo_out, hi_out, stream
        "frame_range": [_P, _I, _P, _I, _I, _L, _L, _I, _I, _P, _P, _L, _P,
                        _P, _P],
        # is_f64, run, vals, mask, lo, hi, n, out, stream
        "frame_sum": [_I, _P, _P, _P, _P, _P, _L, _P, _P],
        # is_f64, is_max, vals, mask, identity_bits, lo, hi, n, out,
        # out_valid, stream
        "frame_minmax": [_I, _I, _P, _P, _L, _P, _P, _L, _P, _P, _P],
        # vals, valid, lo, hi, n, last, ignore_nulls, out, out_valid, stream
        "frame_first_last": [_P, _P, _P, _P, _L, _I, _I, _P, _P, _P],
    },
    "cond_join": {
        # offsets, lo, b_perm, n, total, pi, bi, stream
        "cond_expand": [_P, _P, _P, _L, _L, _P, _P, _P],
        # n, total
        "cond_counts_scratch": [_L, _L],
        # keep, offsets, bi, n, total, pcount, bcount, scratch,
        # scratch_bytes, stream
        "cond_counts": [_P, _P, _P, _L, _L, _P, _P, _P, _L, _P],
        # n_l, n_r, pi, bi, stream
        "cross_pairs": [_L, _L, _P, _P, _P],
    },
    "wide_decimal": {
        # op, a, a_rows, a_wide, ka, b, b_rows, b_wide, kb, valid, n, out,
        # stream
        "wd_elementwise": [_I, _P, _L, _I, _I, _P, _L, _I, _I, _P, _L, _P,
                           _P],
        # nlanes, lanes[], count, m, precision, out, out_valid, overflowed,
        # stream
        "wd_sum_finalize": [_I, _P, _P, _L, _I, _P, _P, _P, _P],
    },
    "sample": {
        # k0, k1, fraction, sel, num_rows, cap, out, stream
        "sample_mask": [_L, _L, _D, _P, _L, _L, _P, _P],
        # k0, k1, x0, x1, n, out0, out1, stream
        "threefry": [_L, _L, _P, _P, _L, _P, _P, _P],
    },
    "explode": {
        # n, starts, eoffs, lo, m, values, values_valid, elem_bytes,
        # out_values, out_valid, ncols, in[], out[], vin[], vout[], elems[],
        # stream
        "explode": [_L, _P, _P, _L, _L, _P, _P, _I, _P, _P, _I, _P, _P, _P,
                    _P, _P, _P],
    },
    "key_stats": {
        # key, elem, valid, active, n, pre, alt, out, vcap, hist, tiles,
        # blocks, stream
        "key_stats": [_P, _I, _P, _P, _L, _P, _P, _P, _L, _P, _P, _I, _P],
    },
    "bucketize": {
        # n, nparts
        "bucketize_scratch": [_L, _I],
        # pids, active, n, nparts, cap, ncols, in[], out[], elems[], sent,
        # overflow, scratch, scratch_bytes, stream
        "bucketize": [_P, _P, _L, _I, _L, _I, _P, _P, _P, _P, _P, _P, _L,
                      _P],
    },
    "group_ratio": {
        "group_ratio_scratch_words": [],
        # h, active, n, scratch, out, stream
        "group_ratio": [_P, _P, _L, _P, _P, _P],
    },
    "compact": {
        # n
        "compact_scratch": [_L],
        # ncols, in[], out[], vin[], vout[], elems[], active, n, n_live,
        # scratch, scratch_bytes, stream
        "compact": [_I, _P, _P, _P, _P, _P, _P, _L, _L, _P, _L, _P],
    },
}

# entries that return other than a CUDA error code
_RESTYPES = {"sort_build_scratch": _L, "sort_perm_scratch": _L,
             "topk_scratch": _L, "csr_build_scratch": _L,
             "partition_perm_scratch": _L, "win_scratch_bytes": _L,
             "cond_counts_scratch": _L, "bucketize_scratch": _L,
             "compact_scratch": _L, "group_ratio_scratch_words": _L}

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
    for header in sorted(CSRC.glob("*.cuh")):  # what a source may include
        h.update(header.read_bytes())
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
            for entry, argtypes in _SIGNATURES[name].items():
                fn = getattr(lib, entry)
                fn.argtypes = argtypes
                fn.restype = _RESTYPES.get(entry, ctypes.c_int)
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


def int64_array(vals) -> ctypes.Array:
    """A host array of C int64s."""
    return (ctypes.c_longlong * max(len(vals), 1))(*vals)

"""ctypes loader for the native C++ oracle (builds on first import).

Build is cached next to the source keyed on mtime; rebuilds automatically
when oracle.cpp changes. Falls back with a clear error if no compiler.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "oracle.cpp")
_SO = os.path.join(_DIR, "_oracle.so")

_lib = None
_lib_lock = __import__("threading").Lock()


def _build():
    # build to a per-process temp name + atomic rename: concurrent bin
    # workers AND concurrent processes (parallel CLI runs, test workers)
    # must never dlopen a half-written .so, and two processes must not
    # race g++ onto the same tmp file
    tmp = f"{_SO}.tmp.{os.getpid()}"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
           "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


_build_failed: Exception | None = None


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    # cache build FAILURE too (advisor r4): without this, every tiny
    # locate/sort batch on a g++-less host re-spawns the failing
    # compiler subprocess inside its try/except before falling back —
    # per-dispatch subprocess latency on exactly the hot paths the
    # native routing exists to speed up
    if _build_failed is not None:
        raise _build_failed
    with _lib_lock:
        return _lib_locked()


def _lib_locked() -> ctypes.CDLL:
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed is not None:
        raise _build_failed
    if (not os.path.exists(_SO)
            or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
        try:
            _build()
        except Exception as e:
            _build_failed = e
            raise
    L = ctypes.CDLL(_SO)
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    L.orc_edit_distance.argtypes = [u8p, ctypes.c_int, u8p, ctypes.c_int,
                                    ctypes.c_int]
    L.orc_edit_distance.restype = ctypes.c_int
    L.orc_all_vs_all.argtypes = [u8p, i64p, i32p, ctypes.c_int,
                                 ctypes.c_double, i32p, ctypes.c_int]
    L.orc_all_vs_all.restype = ctypes.c_long
    L.orc_locate.argtypes = [u8p, ctypes.c_int, u8p, ctypes.c_int,
                             ctypes.c_double, ctypes.c_int, ctypes.c_int,
                             i32p]
    L.orc_locate.restype = ctypes.c_int
    L.orc_locate_batch.argtypes = [u8p, i32p, i32p, ctypes.c_int,
                                   u8p, i64p, i32p, ctypes.c_int,
                                   ctypes.c_double, ctypes.c_int,
                                   ctypes.c_int, i32p, u8p, ctypes.c_int]
    L.orc_locate_batch.restype = None
    L.orc_nw_path.argtypes = [u8p, ctypes.c_int, u8p, ctypes.c_int,
                              ctypes.c_int, u8p, ctypes.c_int]
    L.orc_nw_path.restype = ctypes.c_int
    L.orc_nw_path_batch.argtypes = [u8p, i64p, i32p, ctypes.c_int,
                                    u8p, ctypes.c_int,
                                    u8p, ctypes.c_int, i32p, ctypes.c_int]
    L.orc_nw_path_batch.restype = None
    L.orc_orient_batch.argtypes = [u8p, ctypes.c_int, u8p, i64p, i32p,
                                   ctypes.c_int, i32p, i32p, ctypes.c_int]
    L.orc_orient_batch.restype = None
    L.orc_pileup_batch.argtypes = [u8p, i64p, i32p, ctypes.c_int,
                                   u8p, ctypes.c_int, i32p, ctypes.c_int,
                                   ctypes.c_int]
    L.orc_pileup_batch.restype = ctypes.c_long
    L.orc_nw_dist_batch.argtypes = [u8p, ctypes.c_int, u8p, i64p, i32p,
                                    ctypes.c_int, i32p, ctypes.c_int]
    L.orc_nw_dist_batch.restype = None
    L.orc_hw_pairs.argtypes = [u8p, i64p, i32p, i32p, i32p, ctypes.c_int,
                               i32p, i32p, ctypes.c_int]
    L.orc_hw_pairs.restype = None
    _lib = L
    return L


# ---------------------------------------------------------------------------
# NumPy-friendly wrappers
# ---------------------------------------------------------------------------

def edit_distance(a_codes: np.ndarray, b_codes: np.ndarray,
                  mode: str = "NW") -> int:
    modes = {"NW": 0, "SHW": 1, "HW": 2}
    a = np.ascontiguousarray(a_codes, dtype=np.uint8)
    b = np.ascontiguousarray(b_codes, dtype=np.uint8)
    return lib().orc_edit_distance(a, len(a), b, len(b), modes[mode])


def all_vs_all(codes_list, band: float = 1.05,
               nthreads: int = 0) -> np.ndarray:
    """Upper-triangle NW distance matrix with the 5% length gate; -1 where
    gated. Mirrors amplicon_sorter's pair enumeration (:680).
    nthreads 0 = auto (ORC_THREADS env or hardware); 1 = single-core
    (the bench baseline mode)."""
    n = len(codes_list)
    seqs = np.concatenate([np.ascontiguousarray(c, dtype=np.uint8)
                           for c in codes_list])
    lens = np.array([len(c) for c in codes_list], dtype=np.int32)
    offs = np.zeros(n, dtype=np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    out = np.full((n, n), -1, dtype=np.int32)
    lib().orc_all_vs_all(seqs, offs, lens, n, float(band), out, nthreads)
    return out


def locate(ref_masks: np.ndarray, qry_masks: np.ndarray, e: float,
           flags: int, min_overlap: int = 3):
    out = np.zeros(6, dtype=np.int32)
    r = np.ascontiguousarray(ref_masks, dtype=np.uint8)
    q = np.ascontiguousarray(qry_masks, dtype=np.uint8)
    ok = lib().orc_locate(r, len(r), q, len(q), e, int(flags), min_overlap,
                          out)
    return tuple(int(x) for x in out) if ok else None


def locate_batch(ref_masks_list, qry_masks_list, e: float, flags: int,
                 min_overlap: int = 3, nthreads: int = 0):
    A, B = len(ref_masks_list), len(qry_masks_list)
    refs = np.concatenate([np.ascontiguousarray(r, np.uint8)
                           for r in ref_masks_list])
    rlens = np.array([len(r) for r in ref_masks_list], np.int32)
    roffs = np.zeros(A, np.int32)
    np.cumsum(rlens[:-1], out=roffs[1:])
    qrys = np.concatenate([np.ascontiguousarray(q, np.uint8)
                           for q in qry_masks_list]) if B else np.zeros(0, np.uint8)
    qlens = np.array([len(q) for q in qry_masks_list], np.int32)
    qoffs = np.zeros(B, np.int64)
    if B > 1:
        np.cumsum(qlens[:-1].astype(np.int64), out=qoffs[1:])
    out = np.zeros((B, A, 6), np.int32)
    valid = np.zeros((B, A), np.uint8)
    lib().orc_locate_batch(refs, roffs, rlens, A, qrys, qoffs, qlens, B,
                           e, int(flags), min_overlap,
                           out.reshape(-1), valid.reshape(-1), nthreads)
    return out, valid.astype(bool)


def _concat(codes_list):
    n = len(codes_list)
    seqs = (np.concatenate([np.ascontiguousarray(c, np.uint8)
                            for c in codes_list])
            if n else np.zeros(0, np.uint8))
    lens = np.array([len(c) for c in codes_list], np.int32)
    offs = np.zeros(n, np.int64)
    if n > 1:
        np.cumsum(lens[:-1].astype(np.int64), out=offs[1:])
    return seqs, offs, lens


def nw_path_batch(codes_list, cons_codes: np.ndarray):
    """Align every sequence in ``codes_list`` against one consensus;
    returns a list of op arrays (0=diag 1=consume-seq 2=consume-cons).
    One ctypes crossing for the whole group."""
    n = len(codes_list)
    cons = np.ascontiguousarray(cons_codes, dtype=np.uint8)
    if n == 0:
        return []
    seqs, offs, lens = _concat(codes_list)
    stride = int(lens.max()) + len(cons) + 1
    ops = np.zeros((n, stride), np.uint8)
    nops = np.zeros(n, np.int32)
    lib().orc_nw_path_batch(seqs, offs, lens, n, cons, len(cons),
                            ops.reshape(-1), stride, nops, 0)
    if (nops < 0).any():
        raise RuntimeError("nw_path_batch band overflow")
    return [ops[i, :nops[i]] for i in range(n)]


def pileup_batch(codes_list, cons_codes: np.ndarray,
                 nthreads: int = 0) -> np.ndarray:
    """Fused star-alignment pileup: per-column base counts [W, 5] over
    reads aligned to ``cons_codes`` (draft row included in the votes),
    in the exact column layout of consensus._align_rows. One ctypes
    crossing, NW paths threaded."""
    cons = np.ascontiguousarray(cons_codes, dtype=np.uint8)
    n = len(codes_list)
    if n == 0:
        counts = np.zeros((len(cons), 5), np.int32)
        counts[np.arange(len(cons)), cons.astype(int)] = 1
        return counts
    seqs, offs, lens = _concat(codes_list)
    capw = int(lens.max()) + 2 * len(cons) + 16
    counts = np.zeros((capw, 5), np.int32)
    w = lib().orc_pileup_batch(seqs, offs, lens, n, cons, len(cons),
                               counts.reshape(-1), capw, nthreads)
    if w < 0:  # width exceeded the cap: retry with the worst-case bound
        capw = int(lens.sum()) + len(cons) + 16
        counts = np.zeros((capw, 5), np.int32)
        w = lib().orc_pileup_batch(seqs, offs, lens, n, cons, len(cons),
                                   counts.reshape(-1), capw, nthreads)
        if w < 0:
            raise RuntimeError("pileup_batch width overflow")
    return counts[:w]


def nw_dist_batch(q_codes: np.ndarray, codes_list,
                  nthreads: int = 0) -> np.ndarray:
    """NW distances of one query vs each sequence (threaded batch)."""
    q = np.ascontiguousarray(q_codes, dtype=np.uint8)
    n = len(codes_list)
    d = np.zeros(n, np.int32)
    if n:
        seqs, offs, lens = _concat(codes_list)
        lib().orc_nw_dist_batch(q, len(q), seqs, offs, lens, n, d, nthreads)
    return d


def orient_batch(first_codes: np.ndarray, codes_list):
    """NW distances of ``first`` vs each sequence and vs its reverse
    complement: (d_fwd [n], d_rc [n])."""
    n = len(codes_list)
    first = np.ascontiguousarray(first_codes, dtype=np.uint8)
    d_f = np.zeros(n, np.int32)
    d_r = np.zeros(n, np.int32)
    if n:
        seqs, offs, lens = _concat(codes_list)
        lib().orc_orient_batch(first, len(first), seqs, offs, lens, n,
                               d_f, d_r, 0)
    return d_f, d_r


def hw_pairs(codes_list, pairs_a, pairs_b, nthreads: int = 0):
    """Batched HW(short-in-long) distances for consensus pairs, forward
    and vs the longer's reverse complement: (d_fwd [K], d_rc [K]).
    One ctypes crossing for all merge-loop pairs."""
    pa = np.ascontiguousarray(pairs_a, np.int32)
    pb = np.ascontiguousarray(pairs_b, np.int32)
    K = len(pa)
    d_f = np.zeros(K, np.int32)
    d_r = np.zeros(K, np.int32)
    if K:
        seqs, offs, lens = _concat(codes_list)
        lib().orc_hw_pairs(seqs, offs, lens, pa, pb, K, d_f, d_r,
                           nthreads)
    return d_f, d_r


def nw_path(a_codes: np.ndarray, b_codes: np.ndarray,
            band: int | None = None) -> np.ndarray:
    """Edit script aligning a to b: array of ops 0=diag 1=delete-in-b
    2=insert-in-b. Band auto-set from the exact distance when omitted."""
    a = np.ascontiguousarray(a_codes, dtype=np.uint8)
    b = np.ascontiguousarray(b_codes, dtype=np.uint8)
    if band is None:
        band = max(1, edit_distance(a, b, "NW"))
    cap = len(a) + len(b) + 1
    ops = np.zeros(cap, dtype=np.uint8)
    n = lib().orc_nw_path(a, len(a), b, len(b), int(band), ops, cap)
    if n < 0:
        raise RuntimeError("nw_path band overflow")
    return ops[:n]

"""ctypes bridge to the host-side C++ mask decoder (``csrc/decode.cpp``).

The decoder is built at first use with the system ``g++`` into ``build/``
(named by a hash of the source, so an edit rebuilds) and loaded with
``ctypes``; nothing is built when this module is imported. A failed build or
load raises: there is no fallback here, the caller who wants the numpy
decoder asks ``ops/decode.py`` for ``impl="numpy"``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import numpy as np

_PKG = pathlib.Path(__file__).resolve().parent.parent
SRC = _PKG / "csrc" / "decode.cpp"
BUILD = _PKG / "build"

_I32P = ctypes.POINTER(ctypes.c_int32)
_lock = threading.Lock()
_lib = None

EMPTY_SLOT = ("mask bit points at an empty slot — masks and pid are from "
              "different states")


def load() -> ctypes.CDLL:
    """The loaded decoder library, built from ``csrc/decode.cpp`` at first
    use. Raises RuntimeError when it cannot be built."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
        out = BUILD / f"libmdnl-decode-{digest}.so"
        if not out.exists():
            gxx = shutil.which("g++")
            if gxx is None:
                raise RuntimeError(
                    "g++ not found: the host decoder cannot be built (ask "
                    "for impl='numpy' to decode without it)")
            BUILD.mkdir(parents=True, exist_ok=True)
            tmp = BUILD / f"{out.name}.{os.getpid()}.tmp"
            done = subprocess.run(
                [gxx, "-O3", "-std=c++17", "-shared", "-fPIC", str(SRC), "-o",
                 str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
            if done.returncode != 0:
                raise RuntimeError(f"host decoder build failed\n{done.stdout}")
            os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
        lib = ctypes.CDLL(str(out))
        i32, i64 = ctypes.c_int32, ctypes.c_int64
        lib.mdnl_mask_pair_count.restype = i64
        lib.mdnl_mask_pair_count.argtypes = [_I32P, i32, i32, i32]
        lib.mdnl_decode_half.restype = i64
        lib.mdnl_decode_half.argtypes = [_I32P, _I32P, i32, i32, i32, _I32P,
                                         _I32P, i64]
        lib.mdnl_decode_half_padded.restype = i64
        lib.mdnl_decode_half_padded.argtypes = [_I32P, _I32P, i32, i32, i32,
                                                i64, i64, i32, _I32P, _I32P]
        _lib = lib
        return _lib


def _inputs(masks, pid, mc: int, cap: int):
    """C-contiguous i32 (masks, pid) and the word count, shapes checked."""
    m = np.ascontiguousarray(masks, dtype=np.int32)
    p = np.ascontiguousarray(pid, dtype=np.int32)
    if m.ndim != 5 or m.shape != (5, m.shape[1], mc * mc, mc, 3 * cap):
        raise ValueError(f"masks shape {m.shape} does not match the "
                         f"(5, words, mc², mc, 3·cap) layout at mc={mc}, "
                         f"cap={cap}")
    if p.shape != (mc * mc, mc, cap):
        raise ValueError(f"pid shape {p.shape} != {(mc * mc, mc, cap)}")
    return m, p, int(m.shape[1])


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_I32P)


def decode_half(masks, pid, mc: int, cap: int):
    """Decode packed masks (numpy) to (own pid, partner pid) int32 arrays.
    Raises ValueError if a set bit points at an empty slot."""
    lib = load()
    m, p, words = _inputs(masks, pid, mc, cap)
    total = lib.mdnl_mask_pair_count(_ptr(m), mc, cap, words)
    own = np.empty(total, np.int32)
    partner = np.empty(total, np.int32)
    nout = lib.mdnl_decode_half(_ptr(m), _ptr(p), mc, cap, words, _ptr(own),
                                _ptr(partner), total)
    if nout == -1:
        raise ValueError(EMPTY_SLOT)
    if nout != total:  # the count pass and the decode pass walk the same bits
        raise RuntimeError(f"host decoder wrote {nout} of {total} pairs")
    return own, partner


def decode_half_padded(masks, pid, mc: int, cap: int, n: int, k_cap: int,
                       full: bool):
    """Decode packed masks (numpy) straight into fixed-capacity padded rows
    in one pass: no pair buffer, no sort.

    Returns (idx (n, k_cap) i32 padded with the sentinel n, cnt (n,) i32,
    max_count). If max_count > k_cap the rows are cut (counts stay right):
    the caller re-calls with a larger k_cap or raises."""
    lib = load()
    m, p, words = _inputs(masks, pid, mc, cap)
    idx = np.empty((n, k_cap), np.int32)
    cnt = np.empty((n,), np.int32)
    maxc = lib.mdnl_decode_half_padded(_ptr(m), _ptr(p), mc, cap, words, n,
                                       k_cap, 1 if full else 0, _ptr(idx),
                                       _ptr(cnt))
    if maxc == -1:
        raise ValueError(EMPTY_SLOT)
    if maxc == -3:
        raise ValueError(f"n={n} is smaller than max decoded pid")
    return idx, cnt, int(maxc)

"""Build, load and launch the hand-written CUDA kernels under ``csrc/``.

The sources have a plain C interface (no PyTorch headers), so ``nvcc``
compiles each in seconds. ``library()`` compiles every ``csrc/*.cu`` for
``sm_90a`` — one ``nvcc`` per source, all started together — links them into
one shared library under ``build/`` (named by a hash of the sources, so an
edit rebuilds) and loads it with ``ctypes``. Nothing is built when this
module is imported; the first kernel launch builds.

``launch(name, ...)`` is the only place a kernel is launched: it calls the C
entry ``mdnl_<name>`` on PyTorch's current stream, raises when the entry
returns a CUDA error, and adds one to ``LAUNCHES[name]`` (the port's counter
registry ``utils/trace.COUNTS`` holds this dict as its ``launches``; a span's
marker kernels, ``_SPANS``, go uncounted). There is no
fallback: a failed build or launch is an error. ``graph_if`` and
``graph_body`` place the conditional nodes of a captured graph
(``csrc/graph_cond.cu``, for ``utils/graphs.py``); they launch no kernel of
``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points: argument types after which the stream pointer follows.
_ENTRIES = {
    # pos, vel, pid, order (i64), keys_s, row_start, posvel, pid_out, M,
    # rows, mc, cap, park_step
    "expand": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F],
    # pos, masks, counts, mc, cap, L, r2cut, occupied_below (PARK_BASE / 2)
    "lists_half": [_P, _P, _P, _I, _I, _F, _F, _F],
    # pos, force, mc, cap, L, r2cut, occupied_below (PARK_BASE / 2)
    "forces_half": [_P, _P, _I, _I, _F, _F, _F],
    # pos, force, pe, mc, cap, L, r2cut, ushift, occupied_below (want_pe)
    "forces_half_pe": [_P, _P, _P, _I, _I, _F, _F, _F, _F],
    # K3 on the half list: pos, start, nsparse, lanes, force, mc, cap, L,
    # r2cut, occupied_below, capacity
    "forces_list": [_P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _I],
    # the step's half list in one kernel: pos, start, nsparse, lanes, status
    # (scratch), overflow, mc, cap, L, r2cut, occupied_below, capacity
    "list_sparse": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _I],
    # the slab forms of K1-K3: the expand's arguments and key_base; the
    # sweeps' arguments and nz_grid, nz_arr (layers walked, layers read),
    # then occupied_below
    "expand_slab": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I],
    "lists_half_slab": [_P, _P, _P, _I, _I, _F, _F, _I, _I, _F],
    "forces_half_slab": [_P, _P, _I, _I, _F, _F, _I, _I, _F],
    "forces_half_slab_pe": [_P, _P, _P, _I, _I, _F, _F, _F, _I, _I, _F],
    # pos, pe, vir, mc, cap, L, r2cut, ushift, occupied_below
    "pe_virial_half": [_P, _P, _P, _I, _I, _F, _F, _F, _F],
    # pos, counts, mc, cap, L, r2cut, occupied_below (PARK_BASE / 2)
    "count_half": [_P, _P, _I, _I, _F, _F, _F],
    # pos, valid, force, mc, cap, L, r2cut
    "force_full": [_P, _P, _P, _I, _I, _F, _F],
    # pos, valid, force, pe, mc, cap, L, r2cut, ushift (the want_pe form)
    "force_full_pe": [_P, _P, _P, _P, _I, _I, _F, _F, _F],
    # pos, valid, counts, mc, cap, L, r2cut
    "count_full": [_P, _P, _P, _I, _I, _F, _F],
    # stayer pos, vel, pid, mover pos, vel, pid, out pos, vel, pid, rows, mc,
    # cap, park_step
    "merge": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F],
    # the incremental rebuild: pos, pid, pos_w, keys, spid, slots, mc, cap,
    # L, 1/cell; row_start, window, taken, movers, rows, group, records
    "mover_keys": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _F],
    "window_count": [_P, _P, _P, _P, _I, _I, _I],
    # the NVE step's integrator: vel, pos, force, ref_pos, pid, flag (null:
    # no vote), slots, dt/2, dt, f32(skin^2); vel, force, pid, flag (null:
    # none to lower), slots, dt/2
    "kick_drift_vote": [_P, _P, _P, _P, _P, _P, _I, _F, _F, _F],
    "kick": [_P, _P, _P, _P, _I, _F],
}

# the empty marker kernels of the device spans (csrc/span.cu): the stream only
_SPANS = ("span_begin_rebuild", "span_end_rebuild", "span_begin_halflist",
          "span_end_halflist", "span_begin_increment", "span_end_increment")

# kernel launches so far, by kernel; reset_launches() zeroes them
LAUNCHES = {name: 0 for name in _ENTRIES}
_counting = threading.Lock()  # ranks of a LocalRing launch from threads

_lib = None
build_log: list[str] = []  # compiler output of the last build (ptxas -v)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (pathlib.Path(root) / "bin" / "nvcc").exists():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _sources() -> tuple[list[pathlib.Path], str]:
    cu = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(b"")
    for path in cu + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return cu, h.hexdigest()[:16]


def _build(cu: list[pathlib.Path], out: pathlib.Path) -> None:
    nvcc = _nvcc()
    work = BUILD / f"obj-{out.stem}-{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC)]
    procs = []
    for src in cu:  # one nvcc per source, all in flight together
        obj = work / (src.stem + ".o")
        procs.append((obj, subprocess.Popen(
            [nvcc, *flags, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    build_log.clear()
    failed = []
    for obj, proc in procs:
        text, _ = proc.communicate()
        build_log.append(text)
        if proc.returncode != 0:
            failed.append(f"{obj.stem}: nvcc exit {proc.returncode}\n{text}")
    if failed:
        raise RuntimeError("CUDA kernel build failed\n" + "\n".join(failed))
    tmp = work / out.name
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *[str(o) for o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"CUDA kernel link failed\n{link.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    shutil.rmtree(work, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built from ``csrc/`` at first use."""
    global _lib
    if _lib is None:
        cu, digest = _sources()
        out = BUILD / f"libmdnl-{digest}.so"
        if not out.exists():
            _build(cu, out)
        lib = ctypes.CDLL(str(out))
        for name, argtypes in _ENTRIES.items():
            fn = getattr(lib, "mdnl_" + name)
            fn.argtypes = argtypes + [_P]  # every pointer, and the stream
            fn.restype = _I
        for name in _SPANS:
            fn = getattr(lib, "mdnl_" + name)
            fn.argtypes = [_P]
            fn.restype = _I
        lib.mdnl_graph_if.argtypes = [_P, ctypes.POINTER(_P), _P]
        lib.mdnl_graph_body.argtypes = [_P, _P]
        for fn in (lib.mdnl_graph_if, lib.mdnl_graph_body):
            fn.restype = _I
        _lib = lib
    return _lib


def launch(name: str, *args, device=None) -> None:
    """Launch kernel ``name`` on the current stream of ``device`` (default:
    the first argument's). Tensors pass as device pointers; they must be
    contiguous CUDA tensors (the callers check)."""
    fn = getattr(library(), "mdnl_" + name)
    raw = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(args[0].device if device is None else device):
        err = fn(*raw, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name!r} failed to launch "
                           f"(cudaError {err})")
    if name in LAUNCHES:  # a span's markers are not counted
        with _counting:
            LAUNCHES[name] += 1


def graph_if(pred: torch.Tensor) -> int:
    """Append to the graph that the current stream captures an "if" node on
    the 0-d bool CUDA tensor ``pred``; return its empty body graph (a
    ``cudaGraph_t`` as an int) for ``graph_body``."""
    if pred.dtype != torch.bool or pred.numel() != 1 or not pred.is_cuda:
        raise ValueError("a branch condition is a 0-d bool CUDA tensor, got "
                         f"{pred.dtype} of shape {tuple(pred.shape)} on "
                         f"{pred.device}")
    body = _P()
    with torch.cuda.device(pred.device):
        err = library().mdnl_graph_if(pred.data_ptr(), ctypes.byref(body),
                                      torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"conditional graph node not added (cudaError "
                           f"{err}): is the current stream capturing?")
    return body.value


def graph_body(body: int, child: int) -> None:
    """Place the graph ``child`` (a ``cudaGraph_t`` as an int) into the
    conditional body ``body`` from ``graph_if``, as a child graph node."""
    err = library().mdnl_graph_body(body, child)
    if err != 0:
        raise RuntimeError(f"conditional body not filled (cudaError {err})")


def check_cuda(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev or not t.is_contiguous():
            raise ValueError(
                "kernel arguments must be contiguous CUDA tensors on one "
                f"device (got device={t.device}, contiguous="
                f"{t.is_contiguous()})")

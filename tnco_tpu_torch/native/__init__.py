"""ctypes bindings of the port's native host core (``core.cpp``, C++17),
the counterpart of ``tnco_tpu/native/__init__.py``:

- :func:`validate` — flat-tree and contraction validation;
- :func:`total_cost` — exact big-integer total cost (decimal and log2);
- :func:`sa_run` / :func:`sa_run_fw` — the multithreaded CPU SA engines
  over replica batches (infinite memory and finite width), which the
  runners' 'native' engine calls.

The library is built with ``g++`` at the first call, never at import, into
``build/native/`` at the repository root, with the JAX package's flags, so
that both libraries built on one host compute the same bits; it is rebuilt
when ``core.cpp`` is newer.  The build writes a temporary file and renames
it, so concurrent processes may build at once.

``TNCO_TPU_NO_NATIVE`` (any non-empty value) or a host without ``g++``
makes :func:`available` false, and every entry point then returns None, as
in the JAX package.  A compile error of ``core.cpp`` raises
``RuntimeError`` with the compiler's output: it does not quietly send the
runners' 'auto' rule elsewhere.
"""

import ctypes
import os
from pathlib import Path
import shutil
import subprocess
import threading

import numpy as np

__all__ = ['available', 'validate', 'total_cost', 'sa_run', 'sa_run_fw',
           'build', 'BUILD_DIR', 'LIB_PATH']

_SRC = Path(__file__).with_name('core.cpp')
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'native'
LIB_PATH = BUILD_DIR / 'libtnco_native.so'
# The JAX package's flags (tnco_tpu/native/__init__.py), in its order.
CXX_FLAGS = ('-O3', '-march=native', '-std=c++17', '-shared', '-fPIC')
_LOCK = threading.Lock()
_LIB = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    'tnco_validate': (ctypes.c_int32, (_P, _I64, _P, _I64, ctypes.c_int32)),
    'tnco_total_cost': (_I64, (_P, _I64, _P, _I64, _P,
                               ctypes.POINTER(ctypes.c_double),
                               ctypes.c_char_p, _I64)),
    'tnco_sa_run': (_I64, (_P, _P, _I64, _I64, _I64, _P, _I64, _P, _I64,
                           _P, _P, _P, _P, _I64)),
    'tnco_sa_run_fw': (_I64, (_P, _P, _P, _I64, _I64, _I64, _P, _I64, _P,
                              ctypes.c_double, _P, _I64, _I64, _I64, _P,
                              _P, _P, _P, _P, _I64)),
}


def _up_to_date() -> bool:
    return (LIB_PATH.is_file() and
            LIB_PATH.stat().st_mtime >= _SRC.stat().st_mtime)


def build() -> Path | None:
    """Compiles ``core.cpp`` into :data:`LIB_PATH` when it is missing or
    older than the source; None when it is stale and the host has no
    ``g++``.  Raises ``RuntimeError`` with the compiler's output on a
    compile error."""
    if _up_to_date():
        return LIB_PATH
    gxx = shutil.which('g++')
    if gxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f'{LIB_PATH.name}.{os.getpid()}.tmp'
    try:
        out = subprocess.run([gxx, *CXX_FLAGS, '-o', str(tmp), str(_SRC),
                              '-lpthread'], capture_output=True, text=True,
                             timeout=300)
        if out.returncode != 0:
            raise RuntimeError(f'g++ failed to build {_SRC}:\n{out.stderr}')
        os.replace(tmp, LIB_PATH)
    finally:
        tmp.unlink(missing_ok=True)
    return LIB_PATH


def _load():
    """The bound library, built on first use; None when it is switched
    off or cannot be built on this host."""
    global _LIB
    if os.environ.get('TNCO_TPU_NO_NATIVE'):
        return None
    with _LOCK:
        if _LIB is None:
            path = build()
            if path is None:
                return None
            lib = ctypes.CDLL(str(path))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


_ERRORS = {
    1: 'Nodes are not valid',
    2: 'Last node should be root.',
    3: 'There should be only one root.',
    4: 'All leaves should be first.',
    5: 'Number of nodes is not consistent with the number of leaves.',
    6: 'Tree is not valid.',
    7: 'Contraction is not valid.',
    8: 'Contraction is not valid.',
}


def _padded(values, n: int, dtype) -> np.ndarray:
    """``values`` zero-padded to ``n`` entries (the library reads W * 32)."""
    values = np.asarray(values, dtype=dtype).reshape(-1)
    if len(values) > n:
        raise ValueError(f"{len(values)} index dims do not fit {n} lanes.")
    out = np.zeros(n, dtype=dtype)
    out[:len(values)] = values
    return out


def _batch(nodes, inds):
    """Contiguous ``int32 [R, N, 3]`` nodes and ``uint32 [R, N, W]``
    index words, their shapes checked against each other."""
    nodes = np.ascontiguousarray(nodes, dtype=np.int32)
    inds = np.ascontiguousarray(inds, dtype=np.uint32)
    if (inds.ndim != 3 or nodes.shape != inds.shape[:2] + (3,)):
        raise ValueError(f"nodes {nodes.shape} and inds {inds.shape} must "
                         "be [R, N, 3] and [R, N, W].")
    return nodes, inds


def _seeds(seeds, r: int) -> np.ndarray:
    seeds = np.ascontiguousarray(seeds, dtype=np.uint64)
    if seeds.shape != (r,):
        raise ValueError(f"One seed per replica is required ({r}), got "
                         f"{seeds.shape}.")
    return seeds


def validate(nodes: np.ndarray, inds: np.ndarray,
             check_shared_inds: bool = False):
    """(ok, message) for a flat tree; None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    nodes, inds = _batch(np.asarray(nodes)[None], np.asarray(inds)[None])
    code = lib.tnco_validate(nodes.ctypes.data, nodes.shape[1],
                             inds.ctypes.data, inds.shape[2],
                             int(check_shared_inds))
    return (code == 0, _ERRORS.get(code, ''))


def total_cost(nodes: np.ndarray, inds: np.ndarray, dims: np.ndarray):
    """(decimal_string, log2) exact total cost; None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    nodes, inds = _batch(np.asarray(nodes)[None], np.asarray(inds)[None])
    n, w = inds.shape[1:]
    dims_padded = _padded(dims, w * 32, np.int64)
    log2_out = ctypes.c_double()
    needed = lib.tnco_total_cost(nodes.ctypes.data, n, inds.ctypes.data, w,
                                 dims_padded.ctypes.data,
                                 ctypes.byref(log2_out), None, 0)
    buf = ctypes.create_string_buffer(int(needed))
    lib.tnco_total_cost(nodes.ctypes.data, n, inds.ctypes.data, w,
                        dims_padded.ctypes.data, ctypes.byref(log2_out),
                        buf, needed)
    return buf.value.decode(), float(log2_out.value)


def sa_run(nodes: np.ndarray, inds: np.ndarray, log2_dims: np.ndarray,
           betas, seeds, n_threads: int = 0, *, return_final: bool = False):
    """Multithreaded CPU SA over a replica batch (one mt19937 stream per
    replica from its seed).

    Args:
        nodes: ``int32[R, N, 3]`` — updated in place (a contiguous
            ``int32`` array is; another is copied): with each replica's
            best tree (default), or its final tree when ``return_final``.
        inds: ``uint32[R, N, W]`` — the same convention.
        log2_dims: ``float64[n_inds]``.
        betas: one beta per sweep.
        seeds: ``uint64[R]``.
        n_threads: 0 = all cores; the result does not depend on it.
        return_final: chunked-resume mode — the in-place arrays keep the
            final trees and the best trees are returned separately.

    Returns:
        ``(best_log2, total_moves, nodes, inds)`` or, with
        ``return_final``, ``(best_log2, total_moves, nodes, inds,
        best_nodes, best_inds)``; None if the library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    nodes, inds = _batch(nodes, inds)
    r, n, w = inds.shape
    log2_dims = np.asarray(log2_dims, dtype=np.float64)
    log2d = _padded(log2_dims, w * 32, np.float64)
    betas = np.ascontiguousarray(betas, dtype=np.float64)
    seeds = _seeds(seeds, r)
    best = np.zeros(r, dtype=np.float64)
    if return_final:
        best_nodes = np.zeros_like(nodes)
        best_inds = np.zeros_like(inds)
        bn, bi = best_nodes.ctypes.data, best_inds.ctypes.data
    else:
        bn = bi = None
    moves = lib.tnco_sa_run(nodes.ctypes.data, inds.ctypes.data, r, n, w,
                            log2d.ctypes.data, len(log2_dims),
                            betas.ctypes.data, len(betas),
                            seeds.ctypes.data, best.ctypes.data, bn, bi,
                            int(n_threads))
    if return_final:
        return best, int(moves), nodes, inds, best_nodes, best_inds
    return best, int(moves), nodes, inds


def sa_run_fw(nodes, inds, slices, log2_dims, skip_lanes, max_width,
              betas, seeds, reslice_every: int = 10, n_threads: int = 0,
              *, max_new_slices: int = 0, return_final: bool = False):
    """Multithreaded CPU finite-width SA over a replica batch.

    Args mirror :func:`sa_run` plus ``slices`` (``uint32[R, W]``, in/out),
    ``skip_lanes`` (``uint32[W]``), ``max_width``, the reslice cadence and
    the per-move rescue budget ``max_new_slices`` (reference
    greedy/optimizer.hpp:226-321).  Dense cost model.

    Returns ``(best_log2, total_moves, nodes, inds, slices)``, with
    ``return_final`` followed by ``(best_nodes, best_inds, best_slices)``;
    None if the library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    nodes, inds = _batch(nodes, inds)
    r, n, w = inds.shape
    slices = np.ascontiguousarray(slices, dtype=np.uint32)
    if slices.shape != (r, w):
        raise ValueError(f"slices must be [{r}, {w}], got {slices.shape}.")
    log2_dims = np.asarray(log2_dims, dtype=np.float64)
    log2d = _padded(log2_dims, w * 32, np.float64)
    skip = np.zeros(w, dtype=np.uint32)
    skip[:] = np.asarray(skip_lanes, dtype=np.uint32)
    betas = np.ascontiguousarray(betas, dtype=np.float64)
    seeds = _seeds(seeds, r)
    best = np.zeros(r, dtype=np.float64)
    if return_final:
        best_nodes = np.zeros_like(nodes)
        best_inds = np.zeros_like(inds)
        best_slices = np.zeros_like(slices)
        bn, bi, bs = (best_nodes.ctypes.data, best_inds.ctypes.data,
                      best_slices.ctypes.data)
    else:
        bn = bi = bs = None
    moves = lib.tnco_sa_run_fw(
        nodes.ctypes.data, inds.ctypes.data, slices.ctypes.data, r, n, w,
        log2d.ctypes.data, len(log2_dims), skip.ctypes.data,
        float(max_width), betas.ctypes.data, len(betas),
        int(reslice_every), int(max_new_slices), seeds.ctypes.data,
        best.ctypes.data, bn, bi, bs, int(n_threads))
    if return_final:
        return (best, int(moves), nodes, inds, slices, best_nodes,
                best_inds, best_slices)
    return best, int(moves), nodes, inds, slices

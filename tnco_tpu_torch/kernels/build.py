"""Builds and loads the hand-written Hopper kernels (``csrc/*.cu``).

``nvcc`` compiles every source into an object file, all compilers
started together, and links them into one shared library with a plain C
interface under ``build/kernels/`` at the repository root; ``ctypes``
loads it.  The library is rebuilt when a source is newer than it.  The
build happens at the first launch, never at import (the CPU tests import
every module on hosts without ``nvcc``).
"""

import ctypes
import os
from pathlib import Path
import shutil
import subprocess

__all__ = ['load', 'load_walker', 'build', 'up_to_date', 'nvcc_path',
           'BUILD_DIR', 'SOURCES']

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG.parent / 'build' / 'kernels'
SOURCES = ('gather.cu', 'scatter.cu', 'walker.cu', 'probe.cu')
_LIB_NAME = 'libtnco_torch_kernels.so'
# The walker's profiling build (per-phase clock64 sums, read back with
# tnco_walker_prof): libraries of their own, built only by the profiling
# script.
_PROFILE_DEFINES = ('-DTNCO_WALKER_PROFILE',)
# No --use_fast_math, and -fmad=false: the walker's float expressions
# must round as its plain version's torch ops do, one operation at a
# time, with no multiply and add contracted into an FMA (the other
# kernels move words and do no float arithmetic).
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-fmad=false', '-Xcompiler', '-fPIC')

_lib = None
_walker_libs = {}
# Compiler output of the last build (``-Xptxas -v``: registers, shared
# memory and spills per kernel); empty when the library was up to date.
build_log = ''

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    'tnco_gather_gbn': (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    'tnco_inv_ids': (_P, _P, _I, _I, _I, _I, _P),
    'tnco_scatter_rows': (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    'tnco_scatter_gbn': (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    'tnco_probe_loop': (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    'tnco_probe_take': (_P, _P, _P, _I, _I, _I, _P),
    'tnco_walker_im': (_P,) * 10 + (_I,) * 10 + (_P,),
    'tnco_walker_fw': (_P,) * 10 + (_I,) * 10 + (_F, _I, _P),
}
_PROFILE_SIGNATURES = {
    'tnco_walker_im': _SIGNATURES['tnco_walker_im'],
    'tnco_walker_fw': _SIGNATURES['tnco_walker_fw'],
    'tnco_walker_prof': (_P, _I, _I),
}


def nvcc_path() -> str:
    home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    cand = Path(home) / 'bin' / 'nvcc'
    if cand.is_file():
        return str(cand)
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError(
            "nvcc was not found (looked in $CUDA_HOME/bin, /usr/local/cuda/"
            "bin and PATH); the CUDA kernels cannot be built on this host.")
    return found


def up_to_date(sources=SOURCES, lib_name=_LIB_NAME) -> bool:
    """Whether ``build/kernels/<lib_name>`` exists and is newer than every
    source and header (file times only)."""
    lib = BUILD_DIR / lib_name
    deps = [CSRC / s for s in sources] + sorted(CSRC.glob('*.cuh'))
    newest = max(p.stat().st_mtime for p in deps)
    return lib.is_file() and lib.stat().st_mtime >= newest


def build(sources=SOURCES, defines=(), lib_name=_LIB_NAME) -> Path:
    """Compiles ``sources`` (names in ``csrc/``, or paths) with the extra
    ``defines`` into ``build/kernels/<lib_name>`` when stale."""
    global build_log
    lib = BUILD_DIR / lib_name
    srcs = [CSRC / s for s in sources]    # an absolute path stays itself
    if up_to_date(sources, lib_name):
        return lib
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f'{os.getpid()}'
    objs = [BUILD_DIR / f'{s.stem}.{tag}.o' for s in srcs]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, *defines, '-Xptxas', '-v', '-c',
                          str(s), '-o', str(o)], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for s, o in zip(srcs, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    failed = [(s, log) for s, p, log in zip(srcs, procs, logs)
              if p.returncode != 0]
    if failed:
        raise RuntimeError('nvcc failed:\n' + '\n'.join(
            f'--- {s.name}\n{log}' for s, log in failed))
    tmp = BUILD_DIR / f'{lib_name}.{tag}.tmp'
    link = subprocess.run([nvcc, '-shared', *map(str, objs), '-o',
                           str(tmp)], capture_output=True, text=True)
    for o in objs:
        o.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError('nvcc link failed:\n' + link.stdout + link.stderr)
    os.replace(tmp, lib)
    build_log = '\n'.join(logs)
    return lib


def _bind(path: Path, signatures) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    if _lib is None:
        _lib = _bind(build(), _SIGNATURES)
    return _lib


def load_walker(source='walker.cu', profile=True) -> ctypes.CDLL:
    """A library of the walker alone, built from ``source`` (a name in
    ``csrc/``, or the path of the first design that the profiling script
    runs as its baseline) into ``build/kernels/``: with ``profile``, its
    profiling build (``-DTNCO_WALKER_PROFILE``: per-phase cycle sums, read
    with ``tnco_walker_prof(out, fw, b)``).  Only
    ``scripts/profile_torch_walker.py`` loads it; the main path never
    does."""
    lib_name = f"libtnco_{Path(source).stem}{'_profile' * profile}.so"
    if lib_name not in _walker_libs:
        defines = _PROFILE_DEFINES if profile else ()
        sigs = _PROFILE_SIGNATURES if profile else {
            k: v for k, v in _PROFILE_SIGNATURES.items()
            if k != 'tnco_walker_prof'}
        _walker_libs[lib_name] = _bind(build((source,), defines, lib_name),
                                       sigs)
    return _walker_libs[lib_name]


def check(rc: int, name: str) -> None:
    """Raises when a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError {rc}).")

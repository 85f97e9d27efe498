"""The port's counterpart of ``tnco_tpu/utils/compile_cache.py``.

The JAX package keeps XLA's compiled programs in a persistent cache, so
that a fresh process skips minutes of compile time.  The port compiles
nothing through XLA: the only artifact it builds and keeps is the
kernels' ``nvcc`` library under ``build/kernels/`` at the repository
root (:mod:`tnco_tpu_torch.kernels.build`), rebuilt at the first launch
when a source is newer.  So :func:`enable` keeps the JAX signature and
its switch, and changes no build setting: it returns the kernel build
directory, or None when disabled (``TNCO_TPU_COMPILE_CACHE`` or
``cache_dir`` set to ``0``, ``off``, ``none`` or ``disabled``).
:func:`probe` reports whether that library is built and up to date; it
never builds.
"""

import os

__all__ = ['enable', 'probe']

_DISABLED = ('0', 'off', 'none', 'disabled')


def enable(cache_dir: str | None = None,
           min_compile_time_secs: float = 2.0) -> str | None:
    """The directory the kernel library is kept in (``build/kernels/``),
    or None when the cache is switched off.  ``cache_dir`` counts only
    as the switch (the build directory is fixed); ``min_compile_time_secs``
    has no counterpart (``nvcc`` output is always kept)."""
    del min_compile_time_secs
    switch = cache_dir or os.environ.get('TNCO_TPU_COMPILE_CACHE') or ''
    if str(switch).lower() in _DISABLED:
        return None
    from tnco_tpu_torch.kernels import build
    return str(build.BUILD_DIR)


def probe() -> dict:
    """``{'enabled', 'cache_dir', 'built', 'up_to_date'}`` of the kernel
    library: whether it exists, and whether it is newer than every
    source (``csrc/*.cu``, ``*.cuh``).  Reads file times only."""
    from tnco_tpu_torch.kernels import build

    return {'enabled': enable() is not None,
            'cache_dir': str(build.BUILD_DIR),
            'built': (build.BUILD_DIR / build._LIB_NAME).is_file(),
            'up_to_date': build.up_to_date()}

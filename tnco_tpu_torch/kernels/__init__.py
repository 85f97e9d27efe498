"""The SA engines and their hand-written Hopper kernels.

Kernels (CUDA C++ under ``csrc/``, each beside its plain PyTorch
version): K1 row gather (:mod:`.gather`), K2 id inversion, K3 in-place
and K4 out-of-place row scatter (:mod:`.scatter`), K5 the multi-walk
walker (:mod:`.walker`), infinite memory (K5-IM) and finite width
(K5-FW), K6 the walk engines' sequential claim (:mod:`.claim`), and P1
the row-read probe, ``loop`` and ``take``
(:mod:`tnco_tpu_torch.benchmarks.gather_probe`).  Each wrapper counts
its launches in the counter registry of
:mod:`tnco_tpu_torch.utils.profiling` (``launches.<kernel>``);
:func:`launch_counts` reads them and :func:`reset_launch_counts` sets
them to 0.
"""

__all__ = ['launch_counts', 'reset_launch_counts']

# The kernel wrappers' launch counters, by the name launch_counts gives.
_LAUNCHES = ('gather_gbn', 'inv_ids', 'scatter_rows_inplace',
             'scatter_rows_gbn', 'walker_im', 'walker_fw', 'probe_loop',
             'probe_take', 'claim_disjoint')


def launch_counts() -> dict:
    from tnco_tpu_torch.utils import profiling
    c = profiling.counts()
    return {k: c.get('launches.' + k, 0) for k in _LAUNCHES}


def reset_launch_counts() -> None:
    from tnco_tpu_torch.utils import profiling
    profiling.reset_counts(['launches.' + k for k in _LAUNCHES])

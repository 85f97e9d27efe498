"""The SA engines and their hand-written Hopper kernels.

Kernels (CUDA C++ under ``csrc/``, each beside its plain PyTorch
version): K1 row gather (:mod:`.gather`), K2 id inversion, K3 in-place
and K4 out-of-place row scatter (:mod:`.scatter`), K5 the multi-walk
walker (:mod:`.walker`), infinite memory (K5-IM) and finite width
(K5-FW), and P1 the row-read probe, ``loop`` and ``take``
(:mod:`tnco_tpu_torch.benchmarks.gather_probe`).  Each wrapper counts
its launches; :func:`launch_counts` reads them and
:func:`reset_launch_counts` sets them to 0.
"""

__all__ = ['launch_counts', 'reset_launch_counts']


def launch_counts() -> dict:
    from tnco_tpu_torch.benchmarks import gather_probe
    from tnco_tpu_torch.kernels import gather, scatter, walker
    return {'gather_gbn': gather.launches,
            'inv_ids': scatter.inv_launches,
            'scatter_rows_inplace': scatter.scatter_launches,
            'scatter_rows_gbn': scatter.gbn_launches,
            'walker_im': walker.launches,
            'walker_fw': walker.launches_fw,
            'probe_loop': gather_probe.loop_launches,
            'probe_take': gather_probe.take_launches}


def reset_launch_counts() -> None:
    from tnco_tpu_torch.benchmarks import gather_probe
    from tnco_tpu_torch.kernels import gather, scatter, walker
    gather.launches = 0
    scatter.inv_launches = 0
    scatter.scatter_launches = 0
    scatter.gbn_launches = 0
    walker.launches = 0
    walker.launches_fw = 0
    gather_probe.loop_launches = 0
    gather_probe.take_launches = 0

"""Multi-device dry run: the port's counterpart of
``__graft_entry__.dryrun_multichip``.

``python -m tnco_tpu_torch.parallel.dryrun N [--device cpu]`` starts ``N``
ranks of one process group (NCCL with one rank per card, or gloo ranks on
the CPU with ``--device cpu``) and runs the JAX dry run's arms on a replica mesh: the
lockstep 'batched' engine with the exchange, the FW 'walks' engine, the
'walker' IM and FW, and the exchange A/B on a Sycamore-like network.
With ``N`` even the mesh is ``(2, N // 2)`` ('dcn', 'ici') and the
exchange keeps to 'ici'; otherwise it is 1-D and the exchange spans it.
"""

import argparse

import numpy as np

from tnco_tpu_torch import mesh as tmesh
from tnco_tpu_torch.device import resolve_device

__all__ = ['dryrun_multichip']


def _check(ok: bool, what) -> None:
    if not ok:
        raise AssertionError(what)


def _trees(ts, out, dims, n, merge_paths=True):
    from tnco_tpu_torch.ctree import ContractionTree
    from tnco_tpu_torch.utils.tn import get_random_contraction_path

    order = tuple(dict.fromkeys(x for xs in ts for x in xs))
    trees = []
    for r in range(n):
        path = get_random_contraction_path(ts, out, seed=r,
                                           merge_paths=merge_paths)
        if not merge_paths:
            path = [p for p in path if p][0]
        trees.append(ContractionTree(path, ts, dims, output_inds=out,
                                     check_shared_inds=True,
                                     inds_order=order))
    return trees


def _dryrun_rank(n_devices: int, device: str) -> str:
    """One rank of the dry run (``__graft_entry__.py:57-207``); every
    rank returns the same summary line."""
    from tnco_tpu_torch.optimize.finite_width import SimpleCostModel
    from tnco_tpu_torch.parallel.replicas import (ReplicaRunner,
                                                  ReplicaRunnerFW)
    from tnco_tpu_torch.testing.networks import lattice_2d, sycamore_like_tn

    if n_devices % 2 == 0 and n_devices > 1:
        mesh = tmesh.make_mesh(shape=(2, n_devices // 2),
                               axis_names=('dcn', 'ici'))
        exchange_axes = ('ici',)
    else:
        mesh = tmesh.make_mesh()
        exchange_axes = None
    b = 2 * n_devices                       # 2 replicas per rank
    seeds = list(range(b))
    ctrees = _trees(*lattice_2d(4, 4), b)
    kw = dict(mesh=mesh, device=device)
    betas = np.linspace(0.0, 5.0, 4, dtype=np.float32)

    runner = ReplicaRunner(ctrees, seeds, engine='batched', **kw)
    runner.run(betas, chunk_size=2, exchange_every=1,
               exchange_axes=exchange_axes)
    best_idx, best = runner.best()
    _check(np.isfinite(best), best)
    _check(0 <= best_idx < b, best_idx)
    _check(runner.min_ctree(best_idx).is_valid(check_shared_inds=True),
           'batched tree')

    fw = ReplicaRunnerFW(ctrees, seeds, cmodel=SimpleCostModel(max_width=3.0),
                         engine='walks', n_walks=4, **kw)
    fw.run(betas, chunk_size=2, update_slices=2, exchange_every=1,
           exchange_axes=exchange_axes)
    lm = fw.log2_min_totals()
    fw_idx = int(np.argmin(lm))
    _check(np.isfinite(lm[fw_idx]), lm)
    _check(fw.min_ctree(fw_idx).is_valid(check_shared_inds=True),
           'walks FW tree')

    wk = ReplicaRunner(ctrees, seeds, engine='walker', n_walks=4, **kw)
    wk.run(betas, chunk_size=2)
    wk_lm = wk.log2_min_totals()
    _check(np.isfinite(np.min(wk_lm)), wk_lm)
    _check(wk.min_ctree(int(np.argmin(wk_lm))).is_valid(
        check_shared_inds=True), 'walker tree')
    wfw = ReplicaRunnerFW(ctrees, seeds,
                          cmodel=SimpleCostModel(max_width=3.0),
                          engine='walker', n_walks=4, **kw)
    wfw.run(betas, chunk_size=2, update_slices=2)
    wfw_lm = wfw.log2_min_totals()
    _check(np.isfinite(np.min(wfw_lm)), wfw_lm)
    _check(wfw.min_ctree(int(np.argmin(wfw_lm))).is_valid(
        check_shared_inds=True), 'walker FW tree')

    # The exchange A/B on a Sycamore-like network at m=4 (N=817): the
    # same seeds and schedule with the 'ici' exchange every 2 chunks and
    # without; the exchanged arm's median and min of the replicas' bests
    # must not be worse.
    ab = ''
    if exchange_axes is not None:
        ab_trees = _trees(*sycamore_like_tn(4, 0), b, merge_paths=False)
        betas_ab = np.linspace(0.0, 30.0, 64, dtype=np.float32)

        def arm(exchange: bool):
            r = ReplicaRunner(ab_trees, seeds, engine='batched', **kw)
            run_kw = dict(chunk_size=8)
            if exchange:
                run_kw.update(exchange_every=2, exchange_axes=exchange_axes)
            r.run(betas_ab, **run_kw)
            m = r.log2_min_totals()
            return float(np.min(m)), float(np.median(m))

        on_min, on_med = arm(True)
        off_min, off_med = arm(False)
        _check(on_med <= off_med + 1e-5, (on_med, off_med))
        _check(on_min <= off_min + 1e-5, (on_min, off_min))
        ab = (f'; exchange A/B (sycamore m=4, N={len(ab_trees[0])}): '
              f'exchanged min/median {on_min:.3f}/{on_med:.3f} vs '
              f'off {off_min:.3f}/{off_med:.3f}')
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return (f'dryrun_multichip OK: {n_devices} ranks (mesh {shape}, '
            f'{device}), best log2 cost {best:.3f} from replica '
            f'{best_idx}; FW walks arm best {float(lm[fw_idx]):.3f}; '
            f'walker arms (IM/FW) best {float(np.min(wk_lm)):.3f}/'
            f'{float(np.min(wfw_lm)):.3f}' + ab)


def dryrun_multichip(n_devices: int, device=None,
                     timeout: float = 600.0) -> str:
    """Runs the dry run on ``n_devices`` ranks, checks that every rank
    gave the same summary, prints it and returns it.  ``device=None``
    means the cards (NCCL, one rank per card) and raises without CUDA;
    ``device='cpu'`` runs gloo ranks on the CPU."""
    dev = resolve_device(device).type
    backend = 'gloo' if dev == 'cpu' else 'nccl'
    lines = tmesh.spawn(_dryrun_rank, n_devices, (n_devices, dev),
                        backend=backend, timeout=timeout)
    _check(len(set(lines)) == 1, lines)
    print(lines[0])
    return lines[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('n_devices', type=int)
    ap.add_argument('--device', choices=('cpu', 'cuda'),
                    help="default: the cards; 'cpu' runs gloo ranks")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())

"""Benchmark: SA move evaluations per second on the 8x8 lattice — the
port of ``bench.py``.

Runs the multi-walk SA engine (:func:`~tnco_tpu_torch.kernels.
sa_multiwalk.run_multiwalk`, the counterpart of the engine the JAX bench
times) on BASELINE config 2, the 2D square lattice 8x8 with bond dim 2:
B=8192 replicas, P=16 walks, 512 iterations on the card (32 replicas and
32 iterations on the CPU).  One warm-up call, then one timed call that
ends in a host read of its counters.  It prints ONE JSON line: moves/s,
applied moves/s, the applied fraction, the device (the card's name and
power limit, as ``nvidia-smi`` prints them) and, on the card,
``kernel_identity``: the walker (K5-IM), the row gather (K1) and the
out-of-place row scatter (K4, with the id inversion K2 inside) held
bitwise against their plain versions at the JAX bench's shapes.  It is
``"ok"`` or ``"FAIL: ..."``; after a failure the line is printed and the
process exits with status 1.

The line compares with no TPU figure: ``bench.py``'s ``vs_baseline``
(1e7 moves/s, a TPU v5e-8 figure) and ``vs_prev_round`` (the TPU rounds'
``BENCH_r*.json``) have no counterpart here.

Usage::

    python -m tnco_tpu_torch.bench [--device cpu]
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from tnco_tpu_torch.ctree import ContractionTree
from tnco_tpu_torch.device import card_info, resolve_device
from tnco_tpu_torch.kernels import gather, scatter, walker
from tnco_tpu_torch.kernels.sa_batched import init_batch
from tnco_tpu_torch.kernels.sa_fullsweep import uniform_log2_dim
from tnco_tpu_torch.kernels.sa_infinite import SweepConfig
from tnco_tpu_torch.kernels.sa_multiwalk import draw_chunk, run_multiwalk
from tnco_tpu_torch.ops.bitops import pad_log2_dims
from tnco_tpu_torch.testing.networks import lattice_2d
from tnco_tpu_torch.testing.utils import (assert_batches_identical,
                                          assert_tensors_identical)
from tnco_tpu_torch.utils.tn import get_random_contraction_path

__all__ = ['main', 'setup', 'sizes', 'N_WALKS']

# P=16 walks, the JAX bench's choice (bench.py:35-39).
N_WALKS = 16
N_PATHS = 64


def sizes(dev: torch.device):
    """``(replicas, iterations)``: the JAX bench's accelerator sizes on
    the card, its CPU sizes on the CPU (bench.py:33-34)."""
    return (8192, 512) if dev.type == 'cuda' else (32, 32)


def setup(n_replicas: int, dev: torch.device):
    """The bench's starting state (bench.py:43-70): ``(ctrees, batch,
    cfg, log2d, log2d_w32, uniform_log2)``; ``log2d`` is the padded
    float32 table as a numpy array."""
    ts_inds, output_inds, dims = lattice_2d(8, 8)
    order = tuple(dict.fromkeys(x for xs in ts_inds for x in xs))
    n_paths = min(n_replicas, N_PATHS)
    trees = [ContractionTree(
        get_random_contraction_path(ts_inds, output_inds, seed=r), ts_inds,
        dims, output_inds=output_inds, check_shared_inds=True,
        inds_order=order) for r in range(n_paths)]
    # Replica r starts from tree r % 64 (the seeds tell the runs apart);
    # init_batch only reads the trees.
    ctrees = [trees[r % n_paths] for r in range(n_replicas)]
    t = ctrees[0]
    n_lanes = t.inds_array.shape[1]
    cfg = SweepConfig(n_leaves=t.n_leaves, n_lanes=n_lanes)
    log2d = pad_log2_dims(t.log2_dims_array, n_lanes).numpy()
    batch = init_batch(ctrees, list(range(n_replicas)), log2d, device=dev)
    log2d_w32 = torch.from_numpy(log2d).reshape(n_lanes, 32).to(dev)
    return (ctrees, batch, cfg, log2d, log2d_w32,
            uniform_log2_dim(t.log2_dims_array))


def _first_difference(checks) -> str:
    """``'ok'``, or ``'FAIL: <what>: <message>'`` for the first of the
    ``(what, assert_same, want, got)`` checks that raises."""
    for what, assert_same, want, got in checks:
        try:
            assert_same(want, got)
        except AssertionError as exc:
            return f'FAIL: {what}: {" ".join(str(exc).split())[:400]}'
    return 'ok'


def _kernel_identity_check(ctrees, log2d, log2d_w32, cfg, dev) -> str:
    """The kernels against their plain versions on the card, at the JAX
    bench's identity-check shapes (bench.py:121-163): the walker on 8
    replicas, P=4, 32 iterations, on the same pre-drawn streams; the row
    gather on ``[2, 8, 256]`` x ``[8, 128]``; the out-of-place scatter
    with unique ids (a permutation of 256 cut to 128 per row)."""
    b, p, k = len(ctrees), 4, 32
    batch = init_batch(ctrees, list(range(b)), log2d, device=dev)
    betas = torch.linspace(0.0, 30.0, k, dtype=torch.float32, device=dev)
    pos = torch.full((p, b), -1, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    draws = draw_chunk(gen, cfg.n_leaves, k, p, b)
    got, mg = walker.run_walker(batch, betas, log2d_w32, cfg, p, pos,
                                draws=draws)
    want, mw = walker.run_walker_plain(batch, betas, log2d_w32, cfg, p, pos,
                                       draws=draws)
    checks = [('walker', assert_batches_identical, want, got)]
    checks += [(f'walker {name}', assert_tensors_identical, mw[name],
                mg[name]) for name in ('pos', 'applied')]

    rng = np.random.default_rng(0)

    def dev_i32(x):
        return torch.from_numpy(np.asarray(x).astype(np.int32)).to(dev)

    vals = dev_i32(rng.integers(-2**31, 2**31, (2, 8, 256), dtype=np.int64))
    ids = dev_i32(rng.integers(0, 256, (8, 128), dtype=np.int64))
    checks.append(('gather_gbn', assert_tensors_identical,
                   gather.gather_plain(vals, ids), gather.gather_gbn(vals,
                                                                     ids)))
    sids = dev_i32(np.stack([rng.permutation(256)[:128] for _ in range(8)]))
    upd = dev_i32(rng.integers(-2**31, 2**31, (2, 8, 128), dtype=np.int64))
    checks.append(('scatter_rows_gbn', assert_tensors_identical,
                   scatter.scatter_rows_gbn_plain(vals, sids, upd),
                   scatter.scatter_rows_gbn(vals, sids, upd)))
    return _first_difference(checks)


def main(device=None) -> dict:
    """Runs the bench on ``device`` (``None``: the card, which must be
    there) and prints its JSON line; returns it as a dict."""
    dev = resolve_device(device)
    n_replicas, n_iters = sizes(dev)
    ctrees, batch, cfg, log2d, log2d_w32, ul = setup(n_replicas, dev)
    betas = torch.linspace(0.0, 30.0, n_iters, dtype=torch.float32,
                           device=dev)
    pos = torch.full((N_WALKS, n_replicas), -1, dtype=torch.int32,
                     device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def run():
        _, m = run_multiwalk(batch, betas, log2d_w32, cfg, N_WALKS, pos,
                             uniform_log2=ul, generator=gen)
        return m['moves'], int(m['applied'])   # the host read synchronises

    run()                                       # warm-up
    t0 = time.perf_counter()
    moves, applied = run()
    elapsed = time.perf_counter() - t0
    out = {
        'metric': 'sa_moves_per_sec_per_chip',
        'value': moves / elapsed,
        'unit': 'moves/s',
        'applied_moves_per_sec': applied / elapsed,
        'applied_fraction': applied / max(moves, 1),
        'config': {'network': '8x8 lattice, bond dim 2',
                   'replicas': n_replicas, 'walks': N_WALKS,
                   'iterations': n_iters},
        'device': card_info(dev),
    }
    if dev.type == 'cuda':
        out['kernel_identity'] = _kernel_identity_check(
            ctrees[:8], log2d, log2d_w32, cfg, dev)
    print(json.dumps(out), flush=True)
    if out.get('kernel_identity', 'ok') != 'ok':
        sys.exit(1)
    return out


if __name__ == '__main__':
    ap = argparse.ArgumentParser(prog='python -m tnco_tpu_torch.bench',
                                 description=__doc__.splitlines()[0])
    ap.add_argument('--device', default=None, help="'cuda' (default) or "
                    "'cpu'")
    main(ap.parse_args().device)

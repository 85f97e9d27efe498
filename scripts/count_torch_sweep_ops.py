#!/usr/bin/env python3
"""Counts the PyTorch ops of one round of the 'sweep' engine.

Builds the Sycamore-like m=20 network whole (``fuse=0``: N=3241, W=64)
on the CPU with B replicas from random greedy paths, and runs chunks of
1 and 3 rounds of the IM engine (``run_fullsweep``) and of the FW
engine (``run_fullsweep_fw``, max_width 30) without and with a reslice
every round, inside a ``TorchDispatchMode`` that counts every aten op
but the views.  Each call of the row gather K1 counts as one op (on the
card it is one launch; on the CPU its plain version is several ops,
which are left out), so the count approximates launches on the card.
It prints the ops of a round (half the difference of the two chunks)
and of a chunk's packing and unpacking (the rest).  A count, not a
time.

Run from the repository root:

    python3 scripts/count_torch_sweep_ops.py [--replicas 8]
"""

import argparse
from pathlib import Path
import sys

_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(_ROOT))

from count_torch_batched_ops import VIEWS  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--replicas', type=int, default=8)
    args = ap.parse_args()

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from tnco_tpu_torch.app import load_tn
    from tnco_tpu_torch.app.finite_width.sa import _build_run_paths
    from tnco_tpu_torch.app.tn import Tensor, TensorNetwork
    from tnco_tpu_torch.ctree import ContractionTree
    from tnco_tpu_torch.kernels import gather as kg
    from tnco_tpu_torch.kernels import sa_fullsweep as sfs
    from tnco_tpu_torch.optimize.finite_width import SimpleCostModel
    from tnco_tpu_torch.parallel import ReplicaRunner, ReplicaRunnerFW
    from tnco_tpu_torch.testing.networks import sycamore_like_tn

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.total = 0
            self.k1 = 0
            self.inside = False

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not self.inside and func.__name__.split('.')[0] not in VIEWS:
                self.total += 1
            return func(*args, **(kwargs or {}))

    ts, out, dims = sycamore_like_tn(20)
    tn = TensorNetwork([Tensor(xs, tuple(dims[x] for x in xs)) for xs in ts],
                       output_inds=out)
    loaded = load_tn(tn, fuse=0, seed=0)
    b = args.replicas
    seeds = list(range(b))
    paths = _build_run_paths(loaded, seeds, 1)
    ctrees = [ContractionTree(p[0], loaded.ts_inds, loaded.dims,
                              output_inds=loaded.output_inds)
              for p in paths]
    plain = kg.gather_plain
    mode = [None]

    def counted(vals, ids, planes=None):
        m = mode[0]
        if m is None or m.inside:
            return plain(vals, ids, planes)
        m.total += 1
        m.k1 += 1
        m.inside = True
        try:
            return plain(vals, ids, planes)
        finally:
            m.inside = False

    kg.gather_plain = counted
    try:
        for fw in (False, True):
            if fw:
                runner = ReplicaRunnerFW(
                    ctrees, seeds, engine='sweep',
                    cmodel=SimpleCostModel(max_width=30), device='cpu')
            else:
                runner = ReplicaRunner(ctrees, seeds, engine='sweep',
                                       device='cpu')
            for reslice in ((False, True) if fw else (False,)):
                seen = []
                for k in (1, 3):
                    gen = torch.Generator().manual_seed(0)
                    kw = dict(uniform_log2=runner.uniform_log2,
                              generator=gen)
                    with Count() as m:
                        mode[0] = m
                        if fw:
                            sfs.run_fullsweep_fw(
                                runner.states, [20.0] * k, [reslice] * k,
                                runner.max_width, runner.log2d_w32,
                                runner.skip_lanes, runner.cfg, **kw)
                        else:
                            sfs.run_fullsweep(runner.states, [20.0] * k,
                                              runner.log2d_w32, runner.cfg,
                                              **kw)
                    mode[0] = None
                    seen.append((m.total, m.k1))
                (t1, k1), (t3, k3) = seen
                what = ('FW, reslice' if reslice else 'FW') if fw else 'IM'
                print(f'sweep {what} B={b} N={len(ctrees[0])}: '
                      f'{(t3 - t1) / 2:g} ops a round ({(k3 - k1) / 2:g} '
                      f'K1 calls), {t1 - (t3 - t1) / 2:g} ops of packing '
                      f'and unpacking a chunk ({k1 - (k3 - k1) / 2:g} K1 '
                      'calls)')
    finally:
        kg.gather_plain = plain
    return 0


if __name__ == '__main__':
    sys.exit(main())

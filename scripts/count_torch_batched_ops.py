#!/usr/bin/env python3
"""Counts the PyTorch ops the lockstep 'batched' engines dispatch.

Builds the batched flagship of ``chip_smoke.py`` on the CPU (Sycamore-
like m=20 at the app's default fuse: N=855, W=26; B=64 replicas; FW:
max_width=30, reslice every 10 sweeps), runs a few sweeps of each
engine under a ``TorchDispatchMode`` that counts every aten op but the
views, and prints ops per sweep, walk steps per sweep and ops per step,
with the most frequent ops.  A count, not a time: on the card most of
these ops are one kernel launch each, but on the CPU each K1 and K3 call
is several ops of its plain version where the card launches once.

Run from the repository root:

    python3 scripts/count_torch_batched_ops.py [--sweeps 10]
"""

import argparse
import collections
from pathlib import Path
import sys

_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(_ROOT))

# Ops that make a view (no kernel on the card).
VIEWS = {'view', '_unsafe_view', 't', 'transpose', 'expand', 'select',
         'slice', 'unsqueeze', 'squeeze', 'permute', 'reshape', 'alias',
         'as_strided', 'detach', 'lift_fresh', 'unbind', 'split'}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--sweeps', type=int, default=10)
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from tnco_tpu_torch.app import load_tn
    from tnco_tpu_torch.app.finite_width.sa import _build_run_paths
    from tnco_tpu_torch.ctree import ContractionTree
    from tnco_tpu_torch.kernels import sa_batched as sb
    from tnco_tpu_torch.optimize.finite_width import SimpleCostModel
    from tnco_tpu_torch.parallel import ReplicaRunner, ReplicaRunnerFW
    from tnco_tpu_torch.testing.networks import sycamore_like_tn
    from tnco_tpu_torch.app.tn import Tensor, TensorNetwork

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.__name__.split('.')[0]
            if name not in VIEWS:
                self.ops[name] += 1
            return func(*args, **(kwargs or {}))

    ts, out, dims = sycamore_like_tn(20)
    tn = TensorNetwork([Tensor(xs, tuple(dims[x] for x in xs)) for xs in ts],
                       output_inds=out)
    loaded = load_tn(tn, seed=0)
    b, n = 64, args.sweeps
    seeds = list(range(b))
    paths = _build_run_paths(loaded, seeds, 1)
    order = tuple(dict.fromkeys(x for xs in loaded.ts_inds for x in xs))
    ctrees = [ContractionTree(p[0], loaded.ts_inds, loaded.dims,
                              output_inds=loaded.output_inds,
                              check_shared_inds=True, inds_order=order)
              for p in paths]
    steps = [0]
    propose = sb._propose

    def counted(*a, **k):
        steps[0] += 1
        return propose(*a, **k)

    sb._propose = counted
    try:
        for name, runner, kw in (
                ('im', ReplicaRunner(ctrees, seeds, engine='batched',
                                     device='cpu'), {}),
                ('fw', ReplicaRunnerFW(ctrees, seeds, engine='batched',
                                       cmodel=SimpleCostModel(max_width=30),
                                       device='cpu'),
                 {'update_slices': 10})):
            runner.run(np.linspace(0.0, 1.0, 2), **kw)       # warm-up
            steps[0] = 0
            with Count() as mode:
                runner.run(np.linspace(0.0, 60.0, n), **kw)
            total = sum(mode.ops.values())
            print(f'{name}: {total / n:.1f} ops per sweep, '
                  f'{steps[0] / n:.1f} walk steps per sweep, '
                  f'{total / max(steps[0], 1):.1f} ops per step; top '
                  f'{mode.ops.most_common(10)}')
    finally:
        sb._propose = propose
    return 0


if __name__ == '__main__':
    sys.exit(main())

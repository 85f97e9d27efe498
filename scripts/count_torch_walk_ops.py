#!/usr/bin/env python3
"""Counts the PyTorch ops of the walks engines' claims and iterations.

Builds the Sycamore-like m=20 network whole (``fuse=0``: N=3241, W=64)
on the CPU with B replicas from random greedy paths, and runs one
iteration of the IM walks engine (P=32, the IM default) under each
claim and acceptance rule ('sequential' round, 'pairwise', 'chained'),
and one FW iteration (P=128, max_width 30, a reslice) under the same
three, inside a ``TorchDispatchMode`` that counts every aten op but the
views.  It prints the ops of the claim step alone (the accept rule and
the scan: elementwise ops only, so on the card each is one kernel
launch, except the 'sequential' scan, which the card runs as one launch
of the claim kernel, ``kernels/claim.py``) and of the whole iteration
(on the CPU each K1 and K3 call is several ops of its plain version
where the card launches once), and the claim's ops per walk.  A count,
not a time.

Run from the repository root:

    python3 scripts/count_torch_walk_ops.py [--replicas 8]
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

    import numpy as np
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from tnco_tpu_torch.app import load_tn
    from tnco_tpu_torch.app.finite_width.sa import _build_run_paths
    from tnco_tpu_torch.app.tn import Tensor, TensorNetwork
    from tnco_tpu_torch.ctree import ContractionTree
    from tnco_tpu_torch.kernels import sa_walks as swk
    from tnco_tpu_torch.optimize.finite_width import SimpleCostModel
    from tnco_tpu_torch.parallel import ReplicaRunner, ReplicaRunnerFW
    from tnco_tpu_torch.testing.networks import sycamore_like_tn

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.total = 0
            self.claim = 0
            self.in_claim = False

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.__name__.split('.')[0] not in VIEWS:
                self.total += 1
                self.claim += self.in_claim
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
    claims = swk._claims
    counter = [Count()]

    def counted_claims(*a, **k):
        counter[0].in_claim = True
        try:
            return claims(*a, **k)
        finally:
            counter[0].in_claim = False

    swk._claims = counted_claims
    rules = (('sequential', {}), ('pairwise', {'claim': 'pairwise'}),
             ('chained', {'accept_rule': 'chained'}))
    try:
        for fw in (False, True):
            if fw:
                runner = ReplicaRunnerFW(
                    ctrees, seeds, engine='walks',
                    cmodel=SimpleCostModel(max_width=30), device='cpu')
            else:
                runner = ReplicaRunner(ctrees, seeds, engine='walks',
                                       device='cpu')
            runner.run(np.linspace(10.0, 20.0, 2), chunk_size=2)   # warm
            p = runner.n_walks
            for name, kw in rules:
                gen = torch.Generator().manual_seed(0)
                common = dict(uniform_log2=runner.uniform_log2,
                              generator=gen, device='cpu', **kw)
                with Count() as mode:
                    counter[0] = mode
                    if fw:
                        swk.run_walks_fw(
                            runner.states, [20.0], [True], runner.max_width,
                            runner.log2d_w32, runner.skip_lanes, runner.cfg,
                            runner._mw_pos, **common)
                    else:
                        swk.run_walks(runner.states, [20.0],
                                      runner.log2d_w32, runner.cfg,
                                      runner._mw_pos, **common)
                print(f"{'FW' if fw else 'IM'} walks P={p} B={b} {name}: "
                      f'{mode.claim} claim ops ({mode.claim / p:.1f} a '
                      f'walk), {mode.total} ops an iteration')
    finally:
        swk._claims = claims
    return 0


if __name__ == '__main__':
    sys.exit(main())

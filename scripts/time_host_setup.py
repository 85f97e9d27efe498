#!/usr/bin/env python3
"""Times the host work a full-network ``optimize`` does before and
after its anneal, on the CPU.

On Sycamore-like m=20 whole (``fuse=0``: N=3241, W=64) for B replicas:
the random greedy paths (``_build_run_paths``), the IM and FW batch
initializers (``init_batch``, ``init_batch_fw`` at max_width 30, whose
greedy host slicer runs per replica), and the exact bigint totals of
the trees (``total_cost_exact``).  Prints seconds for each.  Host times,
not card times: the card's host is another CPU.

Run from the repository root:

    python3 scripts/time_host_setup.py [--replicas 64]
"""

import argparse
from pathlib import Path
import sys
import time

_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(_ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--replicas', type=int, default=64)
    args = ap.parse_args()

    from tnco_tpu_torch.app.finite_width.sa import _build_run_paths
    from tnco_tpu_torch.app.tn import Tensor, TensorNetwork
    from tnco_tpu_torch.ctree import ContractionTree
    from tnco_tpu_torch.kernels import sa_batched as sb
    from tnco_tpu_torch.kernels import sa_finite_batched as sfb
    from tnco_tpu_torch.ops import bitops
    from tnco_tpu_torch.testing.networks import sycamore_like_tn

    ts, out, dims = sycamore_like_tn(20)
    tn = TensorNetwork([Tensor(xs, tuple(dims[x] for x in xs)) for xs in ts],
                       output_inds=out)
    seeds = list(range(args.replicas))
    t0 = time.perf_counter()
    paths = _build_run_paths(tn, seeds, -1)
    print(f'{len(seeds)} greedy paths: {time.perf_counter() - t0:.2f} s')
    trees = [ContractionTree(p[0], ts, dims, output_inds=out) for p in paths]
    w = trees[0].inds_array.shape[1]
    log2d = bitops.pad_log2_dims(trees[0].log2_dims_array, w).numpy()
    for name, fn in (
            ('init_batch', lambda: sb.init_batch(trees, seeds, log2d,
                                                 device='cpu')),
            ('init_batch_fw', lambda: sfb.init_batch_fw(trees, seeds, 30.0,
                                                        log2d,
                                                        device='cpu')),
            ('total_cost_exact', lambda: [t.total_cost_exact()
                                          for t in trees])):
        t0 = time.perf_counter()
        fn()
        print(f'{name}: {time.perf_counter() - t0:.2f} s')
    return 0


if __name__ == '__main__':
    sys.exit(main())

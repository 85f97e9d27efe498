#!/usr/bin/env python3
"""Where the time goes in the port's FW walks engine, on one GPU.

Builds the flagship operating point of ``chip_smoke.py`` (Sycamore-like
m=20, N=3241, W=64; B=64 replicas, P=128 walks, max_width=30, reslice
every 2 steps), warms it up, then profiles a steady window with
``torch.profiler`` and CUDA events:

- wall ms per iteration (host clock around synchronized work, in a
  window without the profiler, and in the profiled window);
- device busy share: summed CUDA kernel time over the profiled window's
  wall time;
- host time and device-timeline extent per engine phase (propose,
  accept, claim, apply, total, reslice), from spans this script wraps
  around the engine's functions (the engine itself carries no
  instrumentation);
- device time per kernel name, top entries, and the three ported
  kernels' totals and launch counts.

Run from the repository root:

    python3 scripts/profile_torch_fw.py [--iters 20] [--out FILE.json]

Prints a summary and one JSON line; ``--out`` also writes the full JSON
(phases and the top kernel table) to a file.
"""

import argparse
import contextlib
import json
from pathlib import Path
import subprocess
import sys
import time

_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(_ROOT))

PHASES = ('_propose_walks', '_accept_walks', '_claim_sequential',
          '_apply_walks', '_lt_from_S', '_reslice')
OURS = {'gather_gbn_kernel': 'gather_gbn',
        'inv_ids_smem_kernel': 'inv_ids', 'inv_ids_global_kernel': 'inv_ids',
        'scatter_rows_kernel': 'scatter_rows_inplace'}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--iters', type=int, default=20)
    ap.add_argument('--out', type=Path, default=None)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('profile_torch_fw: CUDA is not available', file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile, record_function

    from tnco_tpu_torch.app.finite_width.sa import _build_run_paths
    from tnco_tpu_torch.app.tn import Tensor, TensorNetwork
    from tnco_tpu_torch.ctree import ContractionTree
    from tnco_tpu_torch.kernels import sa_walks
    from tnco_tpu_torch.optimize.finite_width import SimpleCostModel
    from tnco_tpu_torch.parallel import ReplicaRunnerFW
    from tnco_tpu_torch.testing.networks import sycamore_like_tn

    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    ts, out, dims = sycamore_like_tn(20)
    tn = TensorNetwork([Tensor(xs, tuple(dims[x] for x in xs)) for xs in ts],
                       output_inds=out)
    b, p = 64, 128
    paths = _build_run_paths(tn, list(range(b)), -1)
    ctrees = [ContractionTree(q[0], ts, dims, output_inds=out)
              for q in paths]
    runner = ReplicaRunnerFW(ctrees, list(range(b)),
                             cmodel=SimpleCostModel(max_width=30),
                             n_walks=p)
    betas = np.linspace(0.0, 60.0, 2 * args.iters + 4)
    runner.run(betas[:4], update_slices=2)                  # warm-up
    torch.cuda.synchronize()
    # Unprofiled window first: the profiler's own cost inflates wall time.
    t0 = time.perf_counter()
    runner.run(betas[4:4 + args.iters], update_slices=2)
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0

    # Spans around the engine's phases (host time; device time of the
    # kernels each one launches is attributed by the profiler).
    for name in PHASES:
        fn = getattr(sa_walks, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            with record_function(_name.strip('_')):
                return _fn(*a, **k)
        setattr(sa_walks, name, wrapped)

    with contextlib.ExitStack() as stack:
        prof = stack.enter_context(profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.run(betas[4 + args.iters:], update_slices=2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n_it = args.iters
    spans = {n.strip('_') for n in PHASES}

    # Device kernels by name.
    def dev_us(ev):
        if hasattr(ev, 'device_time_total'):
            return ev.device_time_total
        return ev.cuda_time_total

    # Kernels by name (the spans' own device-side annotations excluded),
    # and each span's host time and device-timeline extent.
    kern = {}
    phases = {n: {'host_ms_per_iter': 0.0, 'device_span_ms_per_iter': 0.0,
                  'calls_per_iter': 0.0} for n in spans}
    for ev in prof.events():
        if ev.name in spans:
            ph = phases[ev.name]
            if ev.device_type.name == 'CUDA':
                ph['device_span_ms_per_iter'] += dev_us(ev) / 1e3 / n_it
            else:
                ph['host_ms_per_iter'] += (ev.time_range.elapsed_us() /
                                           1e3 / n_it)
                ph['calls_per_iter'] += 1 / n_it
        elif ev.device_type.name == 'CUDA' and dev_us(ev) > 0:
            k = kern.setdefault(ev.name, [0.0, 0])
            k[0] += dev_us(ev) / 1e3
            k[1] += 1
    busy_ms = sum(v[0] for v in kern.values())
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:15]
    ours = {}
    for name, (ms, cnt) in kern.items():
        for key, label in OURS.items():
            if key in name:
                o = ours.setdefault(label, [0.0, 0])
                o[0] += ms
                o[1] += cnt
    result = {
        'card': card, 'iters': n_it, 'B': b, 'P': p,
        'wall_ms_per_iter': 1e3 * wall_plain / n_it,
        'profiled_wall_ms_per_iter': 1e3 * wall / n_it,
        'device_busy_ms_per_iter': busy_ms / n_it,
        'device_busy_share': busy_ms / (1e3 * wall),
        'kernel_launches_per_iter': sum(v[1] for v in kern.values()) / n_it,
        'proposals_per_s': b * p * n_it / wall_plain,
        'phases': phases,
        'ported_kernels': {k: {'device_ms_per_iter': v[0] / n_it,
                               'launches_per_iter': v[1] / n_it}
                           for k, v in ours.items()},
        'top_kernels': [{'name': k[:120], 'device_ms_per_iter': v[0] / n_it,
                         'launches_per_iter': v[1] / n_it}
                        for k, v in top],
    }
    print(f"card: {card}")
    print(f"wall {result['wall_ms_per_iter']:.3f} ms/iter unprofiled, "
          f"{result['profiled_wall_ms_per_iter']:.3f} profiled; kernels "
          f"{result['device_busy_ms_per_iter']:.3f} ms/iter "
          f"({100 * result['device_busy_share']:.1f}% of the profiled "
          f"wall), {result['kernel_launches_per_iter']:.0f} launches/iter")
    for k, v in sorted(phases.items(), key=lambda kv:
                       -kv[1]['host_ms_per_iter']):
        print(f"  phase {k}: host {v['host_ms_per_iter']:.3f} ms, device "
              f"span {v['device_span_ms_per_iter']:.3f} ms, "
              f"{v['calls_per_iter']:.2f} calls per iteration")
    for k, v in result['ported_kernels'].items():
        print(f"  kernel {k}: {v['device_ms_per_iter']:.4f} ms and "
              f"{v['launches_per_iter']:.1f} launches per iteration")
    for row in result['top_kernels'][:8]:
        print(f"  top {row['device_ms_per_iter']:.4f} ms "
              f"x{row['launches_per_iter']:.1f}  {row['name'][:80]}")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps({k: result[k] for k in (
        'card', 'wall_ms_per_iter', 'profiled_wall_ms_per_iter',
        'device_busy_ms_per_iter',
        'device_busy_share', 'kernel_launches_per_iter',
        'proposals_per_s')}))
    try:
        from joblib.externals.loky import get_reusable_executor
        get_reusable_executor().shutdown(wait=True)
    except ImportError:
        pass
    return 0


if __name__ == '__main__':
    sys.exit(main())

#!/usr/bin/env python3
"""Where the time goes in the port's FW engines, on one GPU.

Builds a flagship operating point of ``chip_smoke.py`` on Sycamore-like
m=20 (N=3241, W=64; B=64 replicas, max_width=30), warms it up, times a
window without the profiler, then profiles a window with
``torch.profiler``:

- ``--engine walks`` (default): the walks engine at P=128 walks,
  reslice every 2 steps, per iteration;
- ``--engine walker``: the FW walker (kernel K5-FW) at P=8 walks,
  reslice every 10 steps, per chunk of 128 iterations.

It reports:

- wall ms per iteration or chunk (host clock around synchronized work,
  in a window without the profiler, and in the profiled window);
- device busy share: summed CUDA kernel time over the profiled window's
  wall time;
- host time and device-timeline extent per engine phase (walks:
  propose, accept, claim, apply, total, reslice; walker: draws, packing,
  K5-FW segments, reslices, unpacking, the min check and hyper refresh),
  from spans this script wraps around the engine's functions (the engine
  itself carries no instrumentation);
- device time per kernel name, top entries, and the ported kernels'
  totals and launch counts.

Run from the repository root:

    python3 scripts/profile_torch_fw.py [--engine walks|walker]
        [--iters 20] [--chunks 3] [--out FILE.json]

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

# (module, function) pairs wrapped in spans, per engine.
PHASES = {
    'walks': (('sa_walks', '_propose_walks'), ('sa_walks', '_accept_walks'),
              ('sa_walks', '_claim_sequential'), ('sa_walks', '_apply_walks'),
              ('sa_walks', '_lt_from_S'), ('sa_walks', '_reslice')),
    'walker': (('sa_multiwalk', 'fw_draws'), ('walker', 'kernel_inputs_fw'),
               ('walker', 'walker_fw_segment'),
               ('walker', 'walker_fw_reslice'), ('walker', 'unpack_rows_fw'),
               ('sa_multiwalk', 'finish_batch_fw')),
}
OURS = {'gather_sparse_kernel': 'gather_gbn',
        'gather_rows_kernel': 'gather_gbn',
        'inv_ids_smem_kernel': 'inv_ids', 'inv_ids_global_kernel': 'inv_ids',
        'scatter_rows_kernel': 'scatter_rows_inplace',
        'walker_kernel<true': 'walker_fw'}
K = 128   # walker chunk


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--engine', choices=tuple(PHASES), default='walks')
    ap.add_argument('--iters', type=int, default=20,
                    help='walks: profiled iterations')
    ap.add_argument('--chunks', type=int, default=3,
                    help='walker: profiled chunks of 128 iterations')
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
    from tnco_tpu_torch.kernels import sa_multiwalk, sa_walks, walker
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
    b = 64
    paths = _build_run_paths(tn, list(range(b)), -1)
    ctrees = [ContractionTree(q[0], ts, dims, output_inds=out)
              for q in paths]
    if args.engine == 'walks':
        p, upd, n, unit, per = 128, 2, args.iters, 'iter', 1
        runner = ReplicaRunnerFW(ctrees, list(range(b)),
                                 cmodel=SimpleCostModel(max_width=30),
                                 n_walks=p)
        betas = np.linspace(0.0, 60.0, 2 * n + 4)
        warm, plain_win, prof_win = (betas[:4], betas[4:4 + n],
                                     betas[4 + n:])
    else:
        p, upd, n, unit, per = 8, 10, args.chunks, 'chunk', K
        runner = ReplicaRunnerFW(ctrees, list(range(b)),
                                 cmodel=SimpleCostModel(max_width=30),
                                 engine='walker')
        betas = np.linspace(0.0, 60.0, (2 * n + 1) * K)
        warm, plain_win, prof_win = (betas[:K], betas[K:(n + 1) * K],
                                     betas[(n + 1) * K:])
    runner.run(warm, update_slices=upd)                     # warm-up
    torch.cuda.synchronize()
    # Unprofiled window first: the profiler's own cost inflates wall time.
    applied0 = runner.applied_done
    t0 = time.perf_counter()
    runner.run(plain_win, update_slices=upd)
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    applied = runner.applied_done - applied0

    # Spans around the engine's phases (host time; device time of the
    # kernels each one launches is attributed by the profiler).
    mods = {'sa_walks': sa_walks, 'sa_multiwalk': sa_multiwalk,
            'walker': walker}
    for mod, name in PHASES[args.engine]:
        fn = getattr(mods[mod], name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            with record_function(_name.strip('_')):
                return _fn(*a, **k)
        setattr(mods[mod], name, wrapped)

    with contextlib.ExitStack() as stack:
        prof = stack.enter_context(profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.run(prof_win, update_slices=upd)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = {name.strip('_') for _, name in PHASES[args.engine]}

    def dev_us(ev):
        if hasattr(ev, 'device_time_total'):
            return ev.device_time_total
        return ev.cuda_time_total

    # Kernels by name (the spans' own device-side annotations excluded),
    # and each span's host time and device-timeline extent.
    kern = {}
    phases = {s: {f'host_ms_per_{unit}': 0.0,
                  f'device_span_ms_per_{unit}': 0.0,
                  f'calls_per_{unit}': 0.0} for s in spans}
    for ev in prof.events():
        if ev.name in spans:
            ph = phases[ev.name]
            if ev.device_type.name == 'CUDA':
                ph[f'device_span_ms_per_{unit}'] += dev_us(ev) / 1e3 / n
            else:
                ph[f'host_ms_per_{unit}'] += (ev.time_range.elapsed_us() /
                                              1e3 / n)
                ph[f'calls_per_{unit}'] += 1 / n
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
        'card': card, 'engine': args.engine, unit + 's': n, 'B': b, 'P': p,
        'update_slices': upd,
        f'wall_ms_per_{unit}': 1e3 * wall_plain / n,
        f'profiled_wall_ms_per_{unit}': 1e3 * wall / n,
        f'device_busy_ms_per_{unit}': busy_ms / n,
        'device_busy_share': busy_ms / (1e3 * wall),
        f'kernel_launches_per_{unit}': sum(v[1] for v in kern.values()) / n,
        'proposals_per_s': b * p * per * n / wall_plain,
        'applied_per_s': applied / wall_plain,
        'phases': phases,
        'ported_kernels': {k: {f'device_ms_per_{unit}': v[0] / n,
                               f'launches_per_{unit}': v[1] / n}
                           for k, v in ours.items()},
        'top_kernels': [{'name': k[:120], f'device_ms_per_{unit}': v[0] / n,
                         f'launches_per_{unit}': v[1] / n}
                        for k, v in top],
    }
    print(f"card: {card}")
    print(f"engine {args.engine}: wall {result[f'wall_ms_per_{unit}']:.3f} "
          f"ms/{unit} unprofiled, "
          f"{result[f'profiled_wall_ms_per_{unit}']:.3f} profiled; kernels "
          f"{result[f'device_busy_ms_per_{unit}']:.3f} ms/{unit} "
          f"({100 * result['device_busy_share']:.1f}% of the profiled "
          f"wall), {result[f'kernel_launches_per_{unit}']:.0f} "
          f"launches/{unit}")
    for k, v in sorted(phases.items(), key=lambda kv:
                       -kv[1][f'host_ms_per_{unit}']):
        print(f"  phase {k}: host {v[f'host_ms_per_{unit}']:.3f} ms, device "
              f"span {v[f'device_span_ms_per_{unit}']:.3f} ms, "
              f"{v[f'calls_per_{unit}']:.2f} calls per {unit}")
    for k, v in result['ported_kernels'].items():
        print(f"  kernel {k}: {v[f'device_ms_per_{unit}']:.4f} ms and "
              f"{v[f'launches_per_{unit}']:.1f} launches per {unit}")
    for row in result['top_kernels'][:8]:
        print(f"  top {row[f'device_ms_per_{unit}']:.4f} ms "
              f"x{row[f'launches_per_{unit}']:.1f}  {row['name'][:80]}")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps({k: result[k] for k in (
        'card', 'engine', f'wall_ms_per_{unit}',
        f'profiled_wall_ms_per_{unit}', f'device_busy_ms_per_{unit}',
        'device_busy_share', f'kernel_launches_per_{unit}',
        'proposals_per_s', 'applied_per_s')}))
    try:
        from joblib.externals.loky import get_reusable_executor
        get_reusable_executor().shutdown(wait=True)
    except ImportError:
        pass
    return 0


if __name__ == '__main__':
    sys.exit(main())

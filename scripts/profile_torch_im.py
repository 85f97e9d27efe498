#!/usr/bin/env python3
"""Where the time goes in the port's IM walker path, on one GPU.

Builds the IM flagship operating point of ``chip_smoke.py``
(Sycamore-like m=20, N=3241, W=64; B=64 replicas, P=8 walks, chunks of
K=128 iterations, engine 'walker'), warms it up, then times chunks
without the profiler and profiles one more with ``torch.profiler``:

- wall ms per chunk (host clock around synchronized ``run`` calls);
- device busy share: summed CUDA kernel time over the profiled wall;
- host time and device-timeline extent of each step of a chunk (draws,
  packing, the K5 launch, unpacking, the min check and hyper refresh),
  from spans this script wraps around the walker module's functions;
- device time per kernel name, top entries.

Run from the repository root:

    python3 scripts/profile_torch_im.py [--chunks 4] [--out FILE.json]

Prints a summary and one JSON line; ``--out`` also writes the full JSON.
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

K = 128
# (module, function) pairs of one chunk's steps, wrapped in spans.
STEPS = (('sa_multiwalk', 'draw_chunk'), ('walker', 'kernel_inputs'),
         ('walker', 'launch_walker'), ('walker', 'unpack_rows'),
         ('sa_multiwalk', 'finish_batch'))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--chunks', type=int, default=4)
    ap.add_argument('--out', type=Path, default=None)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('profile_torch_im: CUDA is not available', file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile, record_function

    from tnco_tpu_torch.app.finite_width.sa import _build_run_paths
    from tnco_tpu_torch.app.tn import Tensor, TensorNetwork
    from tnco_tpu_torch.ctree import ContractionTree
    from tnco_tpu_torch.kernels import sa_multiwalk, walker
    from tnco_tpu_torch.parallel import ReplicaRunner
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
    runner = ReplicaRunner(ctrees, list(range(b)))
    p = runner.n_walks
    n = args.chunks
    betas = np.linspace(0.0, 60.0, (2 * n + 1) * K)
    runner.run(betas[:K])                                   # warm-up
    torch.cuda.synchronize()
    # Unprofiled window first: the profiler's own cost inflates wall time.
    t0 = time.perf_counter()
    runner.run(betas[K:(n + 1) * K])
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0

    mods = {'sa_multiwalk': sa_multiwalk, 'walker': walker}
    for mod, name in STEPS:
        fn = getattr(mods[mod], name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            with record_function(_name):
                return _fn(*a, **k)
        setattr(mods[mod], name, wrapped)

    with contextlib.ExitStack() as stack:
        prof = stack.enter_context(profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.run(betas[(n + 1) * K:])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(ev):
        if hasattr(ev, 'device_time_total'):
            return ev.device_time_total
        return ev.cuda_time_total

    spans = {name for _, name in STEPS}
    kern = {}
    steps = {s: {'host_ms_per_chunk': 0.0, 'device_span_ms_per_chunk': 0.0}
             for s in spans}
    for ev in prof.events():
        if ev.name in spans:
            if ev.device_type.name == 'CUDA':
                steps[ev.name]['device_span_ms_per_chunk'] += \
                    dev_us(ev) / 1e3 / n
            else:
                steps[ev.name]['host_ms_per_chunk'] += \
                    ev.time_range.elapsed_us() / 1e3 / n
        elif ev.device_type.name == 'CUDA' and dev_us(ev) > 0:
            k = kern.setdefault(ev.name, [0.0, 0])
            k[0] += dev_us(ev) / 1e3
            k[1] += 1
    busy_ms = sum(v[0] for v in kern.values())
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:10]
    walker_ms = sum(v[0] for k, v in kern.items()
                    if 'walker_kernel<false' in k)
    result = {
        'card': card, 'chunks': n, 'K': K, 'B': b, 'P': p,
        'wall_ms_per_chunk': 1e3 * wall_plain / n,
        'profiled_wall_ms_per_chunk': 1e3 * wall / n,
        'device_busy_ms_per_chunk': busy_ms / n,
        'device_busy_share': busy_ms / (1e3 * wall),
        'walker_kernel_ms_per_chunk': walker_ms / n,
        'kernel_launches_per_chunk': sum(v[1] for v in kern.values()) / n,
        'proposals_per_s': b * p * K * n / wall_plain,
        'steps': steps,
        'top_kernels': [{'name': k[:120], 'device_ms_per_chunk': v[0] / n,
                         'launches_per_chunk': v[1] / n} for k, v in top],
    }
    print(f"card: {card}")
    print(f"wall {result['wall_ms_per_chunk']:.3f} ms/chunk unprofiled, "
          f"{result['profiled_wall_ms_per_chunk']:.3f} profiled; kernels "
          f"{result['device_busy_ms_per_chunk']:.3f} ms/chunk "
          f"({100 * result['device_busy_share']:.1f}% of the profiled "
          f"wall; walker {result['walker_kernel_ms_per_chunk']:.3f} ms), "
          f"{result['kernel_launches_per_chunk']:.0f} launches/chunk")
    for k, v in sorted(steps.items(),
                       key=lambda kv: -kv[1]['host_ms_per_chunk']):
        print(f"  step {k}: host {v['host_ms_per_chunk']:.3f} ms, device "
              f"span {v['device_span_ms_per_chunk']:.3f} ms per chunk")
    for row in result['top_kernels'][:8]:
        print(f"  top {row['device_ms_per_chunk']:.4f} ms "
              f"x{row['launches_per_chunk']:.1f}  {row['name'][:80]}")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps({k: result[k] for k in (
        'card', 'wall_ms_per_chunk', 'profiled_wall_ms_per_chunk',
        'device_busy_ms_per_chunk', 'device_busy_share',
        'walker_kernel_ms_per_chunk', 'kernel_launches_per_chunk',
        'proposals_per_s')}))
    return 0


if __name__ == '__main__':
    sys.exit(main())

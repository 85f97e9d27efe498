#!/usr/bin/env python3
"""Where the time goes in the port bench (``tnco_tpu_torch.bench``), on
one GPU.

Builds the bench's operating point (8x8 lattice, bond dim 2, B=8192
replicas, P=16 walks; the eager multi-walk engine ``run_multiwalk``),
warms it up, times ``--iters`` iterations without the profiler (host
clock around a call that ends in a host read, as the bench does), then
profiles the same number with ``torch.profiler``:

- wall ms per iteration, unprofiled and profiled;
- device busy share: summed CUDA kernel time over the profiled wall;
- kernel launches per iteration;
- device time per kernel name, top entries.

Run from the repository root:

    python3 scripts/profile_torch_bench.py [--iters 64] [--out FILE.json]

Prints a summary and one JSON line; ``--out`` also writes the full JSON.
"""

import argparse
import json
from pathlib import Path
import sys
import time

_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(_ROOT))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--iters', type=int, default=64)
    ap.add_argument('--out', type=Path, default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print('profile_torch_bench: CUDA is not available', file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from tnco_tpu_torch import bench
    from tnco_tpu_torch.device import card_info
    from tnco_tpu_torch.kernels.sa_multiwalk import run_multiwalk

    dev = torch.device('cuda')
    card = ', '.join(card_info(dev).values())
    b, _ = bench.sizes(dev)
    p, k = bench.N_WALKS, args.iters
    _, batch, cfg, _, log2d_w32, ul = bench.setup(b, dev)
    betas = torch.linspace(0.0, 30.0, k, dtype=torch.float32, device=dev)
    pos = torch.full((p, b), -1, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def run():
        _, m = run_multiwalk(batch, betas, log2d_w32, cfg, p, pos,
                             uniform_log2=ul, generator=gen)
        return int(m['applied'])

    run()                                                   # warm-up
    t0 = time.perf_counter()
    run()
    wall_plain = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0

    kern = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, 'device_time_total', None)
        if dev_us is None:
            dev_us = ev.cuda_time_total
        if ev.device_type.name == 'CUDA' and dev_us > 0:
            kern[ev.key] = (dev_us / 1e3, ev.count)
    busy_ms = sum(v[0] for v in kern.values())
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:10]
    result = {
        'card': card, 'B': b, 'P': p, 'iterations': k,
        'wall_ms_per_iteration': 1e3 * wall_plain / k,
        'profiled_wall_ms_per_iteration': 1e3 * wall / k,
        'device_busy_ms_per_iteration': busy_ms / k,
        'device_busy_share': busy_ms / (1e3 * wall),
        'kernel_launches_per_iteration': sum(v[1] for v in kern.values()) / k,
        'moves_per_s': b * p * k / wall_plain,
        'top_kernels': [{'name': name[:120], 'device_ms_per_iteration':
                         v[0] / k, 'launches_per_iteration': v[1] / k}
                        for name, v in top],
    }
    print(f'card: {card}')
    print(f"wall {result['wall_ms_per_iteration']:.4f} ms/iteration "
          f"unprofiled, {result['profiled_wall_ms_per_iteration']:.4f} "
          f"profiled; kernels {result['device_busy_ms_per_iteration']:.4f} "
          f"ms/iteration ({100 * result['device_busy_share']:.1f}% of the "
          f"profiled wall), {result['kernel_launches_per_iteration']:.1f} "
          'launches/iteration')
    for row in result['top_kernels'][:8]:
        print(f"  top {row['device_ms_per_iteration']:.4f} ms "
              f"x{row['launches_per_iteration']:.1f}  {row['name'][:80]}")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps({key: result[key] for key in (
        'card', 'wall_ms_per_iteration', 'profiled_wall_ms_per_iteration',
        'device_busy_ms_per_iteration', 'device_busy_share',
        'kernel_launches_per_iteration', 'moves_per_s')}))
    return 0


if __name__ == '__main__':
    sys.exit(main())

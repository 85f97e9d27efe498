#!/usr/bin/env python3
"""Where the time goes in the port's synchronous 'sweep' engine, on one GPU.

Builds the 'sweep' flagship of ``chip_smoke.py`` phase 24 (Sycamore-like
m=20 whole: ``fuse=0``, N=3241, W=64; B=64 replicas from random greedy
paths; FW: max_width=30, reslice every 10 rounds), warms it up, times a
window of rounds without the profiler, then profiles a window with
``torch.profiler``.  It reports:

- wall ms a round (host clock around synchronized work), unprofiled
  and profiled;
- kernel launches a round and the kernels' busy share of the profiled
  wall;
- host ms, device-timeline extent and calls a round of each engine
  phase, from spans this script wraps around the engine's functions
  (propose: the two K1 reads and the proposal, widths included;
  widths: the popcount or pinned widths; accept; luby: the neighbour
  read and the selection; apply: the four K1 pulls and the writes;
  totals; snapshot: the min snapshot; reslice: the slicer and the
  slice-aware cost; hyper: the K1 refresh after the chunk);
- the kernels that take the most device time (name, launches a round,
  device ms a round).

Run from the repository root:

    python3 scripts/profile_torch_sweep.py [--engine im|fw] [--rounds 20]
        [--out FILE.json]

Prints a summary and one JSON line; ``--out`` also writes it to a file.
"""

import argparse
import contextlib
import json
from pathlib import Path
import sys
import time

_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(_ROOT))

# (module, function, span) triples wrapped in spans.
PHASES = (('sfs', '_propose', 'propose'), ('sfs', '_widths', 'widths'),
          ('sfs', '_accept', 'accept'), ('sfs', '_luby_keep', 'luby'),
          ('sfs', '_apply', 'apply'), ('sb', '_lt', 'totals'),
          ('sb', '_snapshot_min', 'snapshot'),
          ('sfb', '_greedy_slices_b', 'reslice'),
          ('sfb', '_lcc_fw_b', 'reslice'),
          ('sb', 'compute_hyper_b', 'hyper'))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--engine', choices=('im', 'fw'), default='im')
    ap.add_argument('--rounds', type=int, default=20)
    ap.add_argument('--out', type=Path, default=None)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('profile_torch_sweep: CUDA is not available', file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile, record_function

    import chip_smoke
    from tnco_tpu_torch.app import load_tn
    from tnco_tpu_torch.app.finite_width.sa import _build_run_paths
    from tnco_tpu_torch.ctree import ContractionTree
    from tnco_tpu_torch.device import card_info
    from tnco_tpu_torch.kernels import sa_batched as sb
    from tnco_tpu_torch.kernels import sa_finite_batched as sfb
    from tnco_tpu_torch.kernels import sa_fullsweep as sfs
    from tnco_tpu_torch.optimize.finite_width import SimpleCostModel
    from tnco_tpu_torch.parallel import ReplicaRunner, ReplicaRunnerFW

    card = ', '.join(card_info(torch.device('cuda')).values())
    fw = args.engine == 'fw'
    _, _, _, tn = chip_smoke._sycamore()
    loaded = load_tn(tn, fuse=0, seed=0)
    b, upd, n = 64, 10, args.rounds
    seeds = list(range(b))
    ctrees = [ContractionTree(p[0], loaded.ts_inds, loaded.dims,
                              output_inds=loaded.output_inds)
              for p in _build_run_paths(loaded, seeds, -1)]
    runner = (ReplicaRunnerFW(ctrees, seeds, engine='sweep',
                              cmodel=SimpleCostModel(max_width=30))
              if fw else ReplicaRunner(ctrees, seeds, engine='sweep'))

    def run(betas):
        kw = dict(update_slices=upd) if fw else {}
        runner.run(betas, chunk_size=64, **kw)

    betas = np.linspace(0.0, 60.0, 2 * n + upd)     # warm-up, plain, profiled
    run(betas[:upd])
    torch.cuda.synchronize()
    moves0 = runner.moves_done
    t0 = time.perf_counter()
    run(betas[upd:upd + n])
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    moves = runner.moves_done - moves0

    mods = {'sb': sb, 'sfb': sfb, 'sfs': sfs}
    originals = []
    for mod, name, span in PHASES:
        fn = getattr(mods[mod], name)
        originals.append((mods[mod], name, fn))

        def wrapped(*a, _fn=fn, _span=span, **k):
            with record_function(_span):
                return _fn(*a, **k)
        setattr(mods[mod], name, wrapped)
    try:
        with contextlib.ExitStack() as stack:
            prof = stack.enter_context(profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(betas[upd + n:])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)

    def dev_us(ev):
        if hasattr(ev, 'device_time_total'):
            return ev.device_time_total
        return ev.cuda_time_total

    spans = {span for _, _, span in PHASES}
    phases = {s: {'host_ms_per_round': 0.0, 'device_span_ms_per_round': 0.0,
                  'calls_per_round': 0.0} for s in spans}
    launches, busy_ms, kernels = 0, 0.0, {}
    for ev in prof.events():
        if ev.name in spans:
            ph = phases[ev.name]
            if ev.device_type.name == 'CUDA':
                ph['device_span_ms_per_round'] += dev_us(ev) / 1e3 / n
            else:
                ph['host_ms_per_round'] += (ev.time_range.elapsed_us() /
                                            1e3 / n)
                ph['calls_per_round'] += 1 / n
        elif ev.device_type.name == 'CUDA' and dev_us(ev) > 0:
            busy_ms += dev_us(ev) / 1e3
            launches += not ev.name.startswith(('Memcpy', 'Memset'))
            k = kernels.setdefault(ev.name[:90], [0, 0.0])
            k[0] += 1
            k[1] += dev_us(ev) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    result = {
        'card': card, 'engine': args.engine, 'rounds': n, 'B': b,
        'N': len(ctrees[0]), 'W': ctrees[0].inds_array.shape[1],
        'update_slices': upd if fw else None,
        'wall_ms_per_round': 1e3 * wall_plain / n,
        'profiled_wall_ms_per_round': 1e3 * wall / n,
        'proposals_per_s': moves / wall_plain,
        'kernel_launches_per_round': launches / n,
        'device_busy_share': busy_ms / (1e3 * wall),
        'phases': phases,
        'top_kernels': [{'name': k, 'launches_per_round': v[0] / n,
                         'device_ms_per_round': v[1] / n} for k, v in top],
    }
    print(f'card: {card}')
    print(f"sweep {args.engine}: wall {result['wall_ms_per_round']:.3f} "
          f"ms/round unprofiled, {result['profiled_wall_ms_per_round']:.3f} "
          f"profiled; {result['kernel_launches_per_round']:.1f} "
          f"launches/round; kernels busy "
          f"{100 * result['device_busy_share']:.1f}%")
    for k, v in sorted(phases.items(),
                       key=lambda kv: -kv[1]['host_ms_per_round']):
        print(f"  phase {k}: host {v['host_ms_per_round']:.3f} ms, device "
              f"span {v['device_span_ms_per_round']:.3f} ms, "
              f"{v['calls_per_round']:.2f} calls a round")
    for t in result['top_kernels']:
        print(f"  kernel {t['device_ms_per_round']:.4f} ms, "
              f"{t['launches_per_round']:.2f} a round: {t['name']}")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    try:
        from joblib.externals.loky import get_reusable_executor
        get_reusable_executor().shutdown(wait=True)
    except ImportError:
        pass
    return 0


if __name__ == '__main__':
    sys.exit(main())

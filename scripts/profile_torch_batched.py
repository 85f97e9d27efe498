#!/usr/bin/env python3
"""Where the time goes in the port's lockstep 'batched' engines, on one GPU.

Builds the batched flagship of ``chip_smoke.py`` (Sycamore-like m=20 at
the app's default fuse: N=855, W=26; B=64 replicas; FW: max_width=30,
reslice every 10 sweeps), warms it up, times a window of sweeps without
the profiler, then profiles a window with ``torch.profiler``.  It
reports:

- wall ms per sweep (host clock around synchronized work): unprofiled,
  profiled, and the profiled window's betas once more without the
  profiler after its session (a session leaves later launches slower);
- kernel launches per sweep and the kernels' busy share of the
  profiled wall;
- host ms, device-timeline extent and calls per sweep of each engine
  phase, from spans this script wraps around the engine's functions
  (propose: the three K1 row reads and the proposal; widths; accept;
  apply: the row writes; active: the parent reads that end the walks;
  totals; reslice: the slicer and the slice-aware cost; hyper: the K1
  refresh after the chunk);
- a row read and a row write in two forms each at the flagship state
  (see ``_row_ops``): host us per eager call and device us per call (a
  CUDA graph of 50 calls, ``chip_smoke._time_ms``).

Run from the repository root:

    python3 scripts/profile_torch_batched.py [--engine im|fw]
        [--sweeps 10] [--out FILE.json]

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
PHASES = (('sb', '_propose', 'propose'), ('sb', '_widths', 'widths'),
          ('sb', '_accept', 'accept'), ('sb', '_apply', 'apply'),
          ('sb', '_par_of', 'active'), ('sb', '_lt', 'totals'),
          ('sfb', '_log2_total_b', 'totals'),
          ('sfb', '_greedy_slices_b', 'reslice'),
          ('sfb', '_lcc_fw_b', 'reslice'),
          ('sb', 'compute_hyper_b', 'hyper'))


def _row_ops(torch, chip_smoke, planes, w, b):
    """A row read and a row write in two forms each, at the flagship
    state: host us per eager call (1000 calls, then one sync) and device
    us per call.  Reads of B rows of W words at one id per replica: a
    ``gather`` on the ``[N, W, B]`` layout with out-of-range ids masked
    to 0 (the engine's first form), and K1 on the ``[F, B, N]`` planes
    (the engine's).  Writes of rows a and b over all F planes where a
    replica accepts (half of them): ``gather``, ``where``, ``scatter_``
    with the rest rewriting their own column 0 (the engine's first
    form), and K3 (``scatter_rows_inplace`` with -1 ids for the rest,
    the engine's)."""
    from tnco_tpu_torch.kernels.gather import gather_gbn
    from tnco_tpu_torch.kernels.scatter import scatter_rows_inplace

    dev = planes.device
    f, _, n = planes.shape
    inds = planes[:w].permute(2, 0, 1).contiguous()        # [N, W, B]
    gen = torch.Generator(device=dev).manual_seed(0)
    pos = torch.randint(0, n, (b,), generator=gen, device=dev,
                        dtype=torch.int32)
    rows = torch.stack([pos, (pos + 1) % n], 1).contiguous()
    ok = torch.rand((b,), generator=gen, device=dev) < 0.5
    upd = torch.randint(0, 1 << 20, (f, b, 2), generator=gen, device=dev,
                        dtype=torch.int32)
    ids_k3 = torch.where(ok[:, None], rows, -1).contiguous()
    lanes = torch.arange(b, device=dev)

    def gather_masked():
        okp = (pos >= 0) & (pos < n)
        idx = torch.where(okp, pos, 0).long()
        return torch.where(okp, inds[idx, :, lanes].T, 0)

    def gather_where_scatter(vals):
        idx = torch.where(ok[:, None], rows, 0).long()[None].expand_as(upd)
        old = vals.gather(2, idx)
        vals.scatter_(2, idx, torch.where(ok[:, None], upd, old))

    p1, p2 = planes.clone(), planes.clone()
    forms = {
        'read gather_masked': gather_masked,
        'read k1_planes': lambda: gather_gbn(planes, pos[:, None]
                                             .contiguous())[:w, :, 0],
        'write gather_where_scatter': lambda: gather_where_scatter(p1),
        'write k3': lambda: scatter_rows_inplace(p2, ids_k3, upd)}
    if not torch.equal(forms['read gather_masked'](),
                       forms['read k1_planes']()):
        raise SystemExit('profile_torch_batched: the two row reads differ')
    forms['write gather_where_scatter']()
    forms['write k3']()
    if not torch.equal(p1, p2):
        raise SystemExit('profile_torch_batched: the two row writes differ')
    out = {}
    for name, fn in forms.items():
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            fn()
        torch.cuda.synchronize()
        host_us = 1e3 * (time.perf_counter() - t0)
        out[name] = {'host_us_per_call': host_us,
                     'device_us_per_call': 1e3 * chip_smoke._time_ms(
                         torch, fn)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--engine', choices=('im', 'fw'), default='fw')
    ap.add_argument('--sweeps', type=int, default=10)
    ap.add_argument('--out', type=Path, default=None)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('profile_torch_batched: CUDA is not available',
              file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile, record_function

    import chip_smoke
    from tnco_tpu_torch.app.finite_width.sa import _build_run_paths
    from tnco_tpu_torch.ctree import ContractionTree
    from tnco_tpu_torch.device import card_info
    from tnco_tpu_torch.kernels import sa_batched as sb
    from tnco_tpu_torch.kernels import sa_finite_batched as sfb
    from tnco_tpu_torch.optimize.finite_width import SimpleCostModel
    from tnco_tpu_torch.parallel import ReplicaRunner, ReplicaRunnerFW

    card = ', '.join(card_info(torch.device('cuda')).values())
    fw = args.engine == 'fw'
    _, loaded = chip_smoke._sycamore_fused(fw)
    b, upd, n = 64, 10, args.sweeps
    seeds = list(range(b))
    paths = _build_run_paths(loaded, seeds, -1)
    order = tuple(dict.fromkeys(x for xs in loaded.ts_inds for x in xs))
    ctrees = [ContractionTree(p[0], loaded.ts_inds, loaded.dims,
                              output_inds=loaded.output_inds,
                              check_shared_inds=True, inds_order=order)
              for p in paths]
    runner = (ReplicaRunnerFW(ctrees, seeds, engine='batched',
                              cmodel=SimpleCostModel(max_width=30))
              if fw else ReplicaRunner(ctrees, seeds, engine='batched'))

    def run(betas):
        if fw:
            runner.run(betas, update_slices=upd)
        else:
            runner.run(betas)

    betas = np.linspace(0.0, 60.0, 2 * n + upd)     # warm-up, plain, profiled
    run(betas[:upd])                                       # warm-up
    torch.cuda.synchronize()
    moves0 = runner.moves_done
    t0 = time.perf_counter()
    run(betas[upd:upd + n])
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    moves = runner.moves_done - moves0
    # The row forms before the profiler: a profiler session slows the
    # host's later launches (measured below).
    row_ops = _row_ops(torch, chip_smoke, sb._pack_state(
        runner.states, ('lcc',) + (('width',) if fw else ()))[1]['planes'],
        runner.states.inds.shape[1], b)

    mods = {'sb': sb, 'sfb': sfb}
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
    # The same window again without the profiler, after its session.
    t0 = time.perf_counter()
    run(betas[upd + n:])
    torch.cuda.synchronize()
    wall_after = time.perf_counter() - t0

    def dev_us(ev):
        if hasattr(ev, 'device_time_total'):
            return ev.device_time_total
        return ev.cuda_time_total

    spans = {span for _, _, span in PHASES}
    phases = {s: {'host_ms_per_sweep': 0.0, 'device_span_ms_per_sweep': 0.0,
                  'calls_per_sweep': 0.0} for s in spans}
    launches, busy_ms = 0, 0.0
    for ev in prof.events():
        if ev.name in spans:
            ph = phases[ev.name]
            if ev.device_type.name == 'CUDA':
                ph['device_span_ms_per_sweep'] += dev_us(ev) / 1e3 / n
            else:
                ph['host_ms_per_sweep'] += (ev.time_range.elapsed_us() /
                                            1e3 / n)
                ph['calls_per_sweep'] += 1 / n
        elif ev.device_type.name == 'CUDA' and dev_us(ev) > 0:
            busy_ms += dev_us(ev) / 1e3
            launches += not ev.name.startswith(('Memcpy', 'Memset'))
    result = {
        'card': card, 'engine': args.engine, 'sweeps': n, 'B': b,
        'N': len(ctrees[0]), 'W': ctrees[0].inds_array.shape[1],
        'update_slices': upd if fw else None,
        'wall_ms_per_sweep': 1e3 * wall_plain / n,
        'profiled_wall_ms_per_sweep': 1e3 * wall / n,
        'moves_per_s': moves / wall_plain,
        'kernel_launches_per_sweep': launches / n,
        'device_busy_share': busy_ms / (1e3 * wall),
        'phases': phases,
        'outside_phases_host_ms_per_sweep': 1e3 * wall / n - sum(
            v['host_ms_per_sweep'] for v in phases.values()),
        'wall_ms_per_sweep_after_profiler': 1e3 * wall_after / n,
        'row_ops': row_ops,
    }
    print(f'card: {card}')
    print(f"batched {args.engine}: wall {result['wall_ms_per_sweep']:.3f} "
          f"ms/sweep unprofiled, {result['profiled_wall_ms_per_sweep']:.3f} "
          f"profiled, {result['wall_ms_per_sweep_after_profiler']:.3f} "
          f"unprofiled after the profiler; "
          f"{result['kernel_launches_per_sweep']:.0f} launches/sweep; "
          f"kernels busy {100 * result['device_busy_share']:.1f}%")
    for k, v in sorted(phases.items(),
                       key=lambda kv: -kv[1]['host_ms_per_sweep']):
        print(f"  phase {k}: host {v['host_ms_per_sweep']:.3f} ms, device "
              f"span {v['device_span_ms_per_sweep']:.3f} ms, "
              f"{v['calls_per_sweep']:.1f} calls per sweep")
    print(f"  outside the phases: host "
          f"{result['outside_phases_host_ms_per_sweep']:.3f} ms")
    for k, v in result['row_ops'].items():
        print(f"  row {k}: host {v['host_us_per_call']:.2f} us, device "
              f"{v['device_us_per_call']:.2f} us per call")
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

#!/usr/bin/env python3
"""Per-phase split of the walker kernel (K5-IM and K5-FW), on one GPU.

Builds the IM and FW walker flagship states of ``chip_smoke.py``
(Sycamore-like m=20, N=3241, W=64; B=64 replicas, P=8 walks; FW with
max_width=30), anneals each through one warm-up chunk of 128 iterations
on the main path, then launches the kernel on that state:

- K5-IM on a chunk of K=128 iterations, K5-FW on one segment of K=10
  (no deferred snapshot), as ``chip_smoke.py`` phase 10 times them;
- each with the network's own log2 dims (all 1: the popcount width
  route) and with a mixed table of the same shape (log2 of dims 2 to 5,
  drawn from ``--seed``: the pinned-tree route).

For each case it reports the kernel's ms per launch (CUDA events around
``--launches`` launches of the main build) and the split of a launch
over the phases proposal, accept, claim, apply, total, snapshot,
prologue and epilogue (a kernel that accepts inside its proposal leaves
accept at 0; one that sums prologue and epilogue together reports them
as prologue).  The split comes from the walker's
profiling build, ``csrc/walker.cu`` compiled with
``-DTNCO_WALKER_PROFILE`` into its own library under
``build/kernels/``: thread 0 of every block sums ``clock64()`` cycles
between block barriers per phase.  Shares are of the summed cycles (mean
over replicas); microseconds per iteration are the shares times the
profiling build's own ms per launch (CUDA events) over K.  Every run of
a case starts from the same packed state.  It also prints the
registers, shared memory and spills that ``-Xptxas -v`` reports.

``--baseline`` also builds the kernel's first design,
``scripts/walker_first_design.cu`` (the walker before its redesign, with
the same entry points and profiling macros), the same two ways; each
case then runs both in turns (first design, current, current, first
design) on the same card in the same call.

Run from the repository root:

    python3 scripts/profile_torch_walker.py [--launches 5] [--seed 0]
        [--baseline] [--out FILE.json]

Prints a summary and one JSON line; ``--out`` also writes the JSON.
"""

import argparse
import ctypes
import json
from pathlib import Path
import subprocess
import sys

_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(_ROOT))

B, P, K_IM, K_FW, MAX_WIDTH = 64, 8, 128, 10, 30.0
FIRST_DESIGN = Path(__file__).resolve().parent / 'walker_first_design.cu'
# The kernel's profiling slots, in its order (csrc/walker.cu): cycles per
# phase, and the count of snapshots taken.
SLOT_NAMES = ('propose', 'accept', 'claim', 'apply', 'total', 'snapshot',
              'prologue', 'snapshots', 'epilogue')
COUNTS = ('snapshots',)
PHASES = tuple(x for x in SLOT_NAMES if x not in COUNTS)
SLOTS = len(SLOT_NAMES)


def _ptxas(log):
    return [line.strip() for line in log.splitlines()
            if 'registers' in line or 'spill' in line or
            'Compiling entry' in line]


def _flagship_states(torch):
    """The IM and FW walker runners after one warm-up chunk each."""
    import numpy as np

    from tnco_tpu_torch.app.finite_width.sa import _build_run_paths
    from tnco_tpu_torch.app.tn import Tensor, TensorNetwork
    from tnco_tpu_torch.ctree import ContractionTree
    from tnco_tpu_torch.optimize.finite_width import SimpleCostModel
    from tnco_tpu_torch.parallel import ReplicaRunner, ReplicaRunnerFW
    from tnco_tpu_torch.testing.networks import sycamore_like_tn

    ts, out, dims = sycamore_like_tn(20)
    tn = TensorNetwork([Tensor(xs, tuple(dims[x] for x in xs)) for xs in ts],
                       output_inds=out)
    seeds = list(range(B))
    paths = _build_run_paths(tn, seeds, -1)
    ctrees = [ContractionTree(p[0], ts, dims, output_inds=out)
              for p in paths]
    betas = np.linspace(0.0, 60.0, K_IM)
    im = ReplicaRunner(ctrees, seeds)
    im.run(betas)
    fw = ReplicaRunnerFW(ctrees, seeds, cmodel=SimpleCostModel(
        max_width=MAX_WIDTH), engine='walker')
    fw.run(betas, update_slices=10)
    torch.cuda.synchronize()
    return im, fw


def _timed(torch, make_launch, lib, n_launches):
    """ms per launch of ``lib`` over ``n_launches`` launches on one
    fresh copy of the case's state, after a warm-up launch on another."""
    make_launch()(lib)
    launch = make_launch()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(n_launches):
        launch(lib)
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / n_launches


def _case(torch, name, k, make_launch, fw, libs, n_launches):
    """One implementation on one case: the main build's ms per launch,
    then the profiling build's phase split and its own ms per launch.
    ``make_launch()`` returns a launcher ``f(lib)`` on a fresh copy of
    the case's state."""
    import numpy as np

    from tnco_tpu_torch.kernels import build

    main_lib, prof_lib = libs
    ms = _timed(torch, make_launch, main_lib, n_launches)
    buf = (ctypes.c_ulonglong * (B * SLOTS))()
    make_launch()(prof_lib)                            # warm-up
    build.check(prof_lib.tnco_walker_prof(buf, int(fw), B), 'walker_prof')
    ms_prof = _timed(torch, make_launch, prof_lib, n_launches)
    build.check(prof_lib.tnco_walker_prof(buf, int(fw), B), 'walker_prof')
    cyc = np.frombuffer(buf, dtype=np.uint64).reshape(B, SLOTS)
    # The counters summed the warm-up launch of _timed and n_launches.
    cyc = cyc.astype(np.float64).mean(axis=0) / (n_launches + 1)
    slot = dict(zip(SLOT_NAMES, cyc))
    per_phase = np.asarray([slot[p] for p in PHASES])
    share = per_phase / per_phase.sum()
    return {'case': name, 'K': k, 'ms_per_launch': ms,
            'profile_ms_per_launch': ms_prof,
            'cycles_per_launch': float(per_phase.sum()),
            **{f'{c}_per_launch': float(slot[c]) for c in COUNTS},
            'phases': {p: {'share': float(share[i]),
                           'us_per_iteration':
                               float(1e3 * ms_prof * share[i] / k)}
                       for i, p in enumerate(PHASES)}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--launches', type=int, default=5)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--baseline', action='store_true',
                    help='run the first design in turns with this one')
    ap.add_argument('--out', type=Path, default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print('profile_torch_walker: CUDA is not available', file=sys.stderr)
        return 2
    from tnco_tpu_torch.kernels import build
    from tnco_tpu_torch.kernels import sa_multiwalk as smw
    from tnco_tpu_torch.kernels import walker as kw
    from tnco_tpu_torch.testing.utils import mixed_log2d_table

    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f'card: {card}', flush=True)
    main_lib = build.load()
    ptxas = {'current': _ptxas(build.build_log)}
    impls = {'current': (main_lib, build.load_walker())}
    ptxas['current profile'] = _ptxas(build.build_log)
    order = ['current']
    if args.baseline:
        base = 'first design'
        impls[base] = (build.load_walker(FIRST_DESIGN, False),)
        ptxas[base] = _ptxas(build.build_log)
        impls[base] += (build.load_walker(FIRST_DESIGN, True),)
        ptxas[f'{base} profile'] = _ptxas(build.build_log)
        order = [base, 'current', 'current', base]
    for which, lines in ptxas.items():
        for line in lines:
            if 'walker' in line or not line.startswith('ptxas info    : '
                                                       'Compiling'):
                print(f'ptxas ({which}): {line}')

    im, fw = _flagship_states(torch)
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    results = []

    # K5-IM: one chunk of K_IM iterations on the IM flagship's state.
    st, pos, cfg = im.states, im._mw_pos, im.cfg
    n = st.c0.shape[0]
    betas = torch.linspace(0.0, 60.0, K_IM, device=dev)
    draws = smw.draw_chunk(gen, cfg.n_leaves, K_IM, P, B)
    for route, table in (('popcount', im.log2d_w32),
                         ('tree', mixed_log2d_table(im.log2d_w32,
                                                    args.seed))):
        def make_launch(table=table):
            ops = kw.kernel_inputs(st, betas, table, pos, draws)

            def launch(lib):
                kw.launch_walker(ops['rows'], ops['min_rows'],
                                 ops['pos_bp'], ops['min_lt'],
                                 ops['applied'], ops['draws'], ops['betas'],
                                 ops['log2d'], cfg, n, cfg.n_lanes, lib=lib)
            return launch
        for impl in order:
            results.append(dict(impl=impl, **_case(
                torch, f'walker_im {route}', K_IM, make_launch, False,
                impls[impl], args.launches)))

    # K5-FW: one segment of K_FW iterations on the FW flagship's state.
    st, pos, cfg = fw.states, fw._mw_pos, fw.cfg
    betas = torch.linspace(30.0, 60.0, K_FW, device=dev)
    dr = {name: x.to(torch.float32 if name == 'u' else torch.int32)
          .contiguous() for name, x in
          smw.draw_chunk(gen, cfg.n_leaves, K_FW, P, B).items()}
    mw = float(fw.max_width)
    for route, table in (('popcount', fw.log2d_w32),
                         ('tree', mixed_log2d_table(fw.log2d_w32,
                                                    args.seed))):
        def make_launch(table=table):
            seg = kw.kernel_inputs_fw(st, pos)

            def launch(lib):
                kw.launch_walker_fw(seg, dr, betas, table, cfg, mw, False,
                                    lib=lib)
            return launch
        for impl in order:
            results.append(dict(impl=impl, **_case(
                torch, f'walker_fw {route}', K_FW, make_launch, True,
                impls[impl], args.launches)))

    for r in results:
        split = ', '.join(f"{p} {v['us_per_iteration']:.3f} us "
                          f"({100 * v['share']:.1f}%)"
                          for p, v in r['phases'].items())
        print(f"{r['impl']} {r['case']}: {r['ms_per_launch']:.4f} ms per "
              f"K={r['K']} launch (profiling build "
              f"{r['profile_ms_per_launch']:.4f}), "
              f"{r['snapshots_per_launch']:.2f} snapshots; per iteration: "
              f"{split}")
    line = {'card': card, 'ptxas': ptxas, 'cases': results}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(line, indent=1))
    print(json.dumps(line))
    return 0


if __name__ == '__main__':
    sys.exit(main())

#!/usr/bin/env python3
"""Times the row-read probe P1 (loop and take) and the id inversion K2
against their first design, in turns, on one GPU, with the floors beside
them.

Builds the kernels (``tnco_tpu_torch/csrc``) and their first design
(``scripts/probe_inv_first_design.cu``: the first P1 and K2 under other
entry-point names, and the floor kernels) into ``build/kernels/``, then,
at the default shapes (P1: state [3328, 128], ids [256, 128]; K2: ids
[64, 256] -> [64, 3328], and [64, 777] -> [64, 20000], the first
design's global-map size):

- checks the new kernels (both routes of the loop), the first design and
  every launch form of the sweep below bitwise against the plain
  versions, the caller's state unchanged;
- times the first design and the new kernel in turns (first, new, new,
  first);
- sweeps the loop's smem route over columns per block {1, 2, 4, 8} (128
  down to 16 blocks) and pairs per thread {1, 2, 4, 8} (within 1024
  threads; ``tnco_probe_loop_form`` of the first-design file, whose form
  (1, 1) is the kept kernel), each beside its barrier floor (the same
  grid doing the 2 R barriers with no memory work);
- measures the card's L2 read rate (the state read 10 and 40 times with
  16-byte loads that skip L1) and the take's floor, an empty kernel on its
  grid plus its row bytes at that rate, and an empty kernel on K2's grid
  (new and first) as K2's floor;
- times K2 at two other slice widths (1024 and 4096 words) beside the
  kept one (the same kernel, given another width), and the loop with the
  next round's ids read in the write phase in turns with the same form
  without it.

Times are device ms per call: calls captured in one CUDA graph, median
of 11 replays (``chip_smoke._time_ms``).  Bounds: each input read once,
each output written once, over 3.35 TB/s.

Run from the repository root:

    python3 scripts/profile_torch_probe_inv.py [--seed 0] [--out FILE.json]

Prints the card's name and power limit, a summary, and one JSON line;
``--out`` also writes the JSON.
"""

import argparse
import json
from pathlib import Path
import sys

_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(_ROOT))

import chip_smoke as cs  # noqa: E402


def _stream(torch):
    return torch.cuda.current_stream().cuda_stream


def _call(torch, lib, name, *args):
    rc = getattr(lib, name)(*args, _stream(torch))
    if rc:
        raise RuntimeError(f'{name} failed to launch (cudaError {rc})')


def _in_turns(torch, first, new, reps=50):
    """first, new, new, first; returns (first ms list, new ms list)."""
    t_first, t_new = [], []
    for order in ('first', 'new', 'new', 'first'):
        if order == 'first':
            t_first.append(cs._time_ms(torch, first, reps=reps))
        else:
            t_new.append(cs._time_ms(torch, new, reps=reps))
    return t_first, t_new


def _forms(p):
    """The sweep's (columns a block, pairs a thread) within 1024
    threads."""
    return [(c, k) for c in (1, 2, 4, 8) for k in (1, 2, 4, 8)
            if -(-p * c // k) <= 1024]


def probe_rows(torch, gen, first):
    from tnco_tpu_torch.benchmarks import gather_probe as gp
    from tnco_tpu_torch.testing.kernel_cases import loop_routes
    n, p, r = cs.N_PAD, cs.PROBE_P, cs.PROBE_R
    state = torch.randint(0, 1 << 20, (n, gp.COLS), generator=gen,
                          device='cuda', dtype=torch.int32)
    ids = torch.randint(0, n, (r, p), generator=gen, device='cuda',
                        dtype=torch.int32)
    before = state.clone()
    nbytes = 4 * (n * gp.COLS + r * p + p * gp.COLS)
    bound_ms = 1e3 * nbytes / cs.HBM_BYTES_PER_S
    out = torch.empty((p, gp.COLS), dtype=torch.int32, device='cuda')
    work = torch.empty_like(state)
    rps = gp.loop_stage_rounds(p)
    rows = []

    def form(c, k, nxt=0):
        _call(torch, first, 'tnco_probe_loop_form', ids.data_ptr(),
              state.data_ptr(), out.data_ptr(), n, p, r, rps, c, k, nxt)

    want = gp.probe_plain(state, ids, 'loop')
    checks = [(f'route {rt}', lambda rt=rt: gp._launch_loop(state, ids, out,
                                                            rt))
              for rt in loop_routes(n, p)]
    checks += [(f'form {c} {k}', lambda c=c, k=k: form(c, k))
               for c, k in _forms(p)]
    checks += [(f'form {c} {k} next ids', lambda c=c, k=k: form(c, k, 1))
               for c, k in ((1, 1), (2, 1), (4, 2))]
    checks.append(('first design', lambda: _call(
        torch, first, 'tnco_probe_loop_first', ids.data_ptr(),
        state.data_ptr(), work.data_ptr(), out.data_ptr(), n, p, r)))
    for name, fn in checks:
        out.zero_()
        fn()
        if not torch.equal(out, want) or not torch.equal(state, before):
            raise SystemExit(f'FAIL: loop {name} != plain')
    route = gp.loop_route(n, p)
    t_first, t_new = _in_turns(
        torch,
        lambda: _call(torch, first, 'tnco_probe_loop_first', ids.data_ptr(),
                      state.data_ptr(), work.data_ptr(), out.data_ptr(), n,
                      p, r),
        lambda: gp._launch_loop(state, ids, out, route), reps=10)
    sink = torch.zeros(gp.COLS, dtype=torch.int32, device='cuda')
    sweep = []
    for c, k in _forms(p):
        need = -(-p * c // k)          # threads of k pairs each
        t = -(-need // 32) * 32        # in whole warps
        ms = cs._time_ms(torch, lambda: form(c, k))
        floor = cs._time_ms(torch, lambda: _call(
            torch, first, 'tnco_barrier_floor', sink.data_ptr(), gp.COLS // c,
            t, r))
        sweep.append(dict(cols=c, pairs=k, threads=t, blocks=gp.COLS // c,
                          ms=ms, barrier_floor_ms=floor))
    # The rejected variant (the next round's ids read in the write
    # phase), in turns with the same form without it.
    pipelined = []
    for c, k in ((1, 1), (2, 1), (4, 2)):
        t_kept, t_var = _in_turns(torch, lambda: form(c, k),
                                  lambda: form(c, k, 1))
        pipelined.append(dict(cols=c, pairs=k, kept_ms=t_kept,
                              pipelined_ms=t_var))
    global_ms = cs._time_ms(torch, lambda: gp._launch_loop(
        state, ids, out, 'global'), reps=10)
    floors = cs.probe_floors(torch, state, p, r, 1)
    plain_ms = cs._time_ms(torch, lambda: gp.probe_plain(state, ids, 'loop'),
                           reps=1, rounds=5)
    rows.append(dict(
        name='P1 loop', shape=f'N={n} P={p} R={r}', row_ops=2 * r * p,
        route=route, threads=gp.loop_threads(p), first_ms=t_first,
        new_ms=t_new, global_route_ms=global_ms, floor_ms=floors['loop_ms'],
        plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms, sweep=sweep,
        pipelined_variant=pipelined))

    want = gp.probe_plain(state, ids, 'take')
    out.zero_()
    _call(torch, first, 'tnco_probe_take_first', ids.data_ptr(),
          state.data_ptr(), out.data_ptr(), n, p, r)
    if not torch.equal(out, want) or not torch.equal(
            gp.probe(state, ids, 'take'), want):
        raise SystemExit('FAIL: take != plain')
    t_first, t_new = _in_turns(
        torch,
        lambda: _call(torch, first, 'tnco_probe_take_first', ids.data_ptr(),
                      state.data_ptr(), out.data_ptr(), n, p, r),
        lambda: gp.probe(state, ids, 'take'))
    plain_ms = cs._time_ms(torch, lambda: gp.probe_plain(state, ids, 'take'))
    rows.append(dict(
        name='P1 take', shape=f'N={n} P={p} R={r}', row_ops=r * p,
        first_ms=t_first, new_ms=t_new, floor_ms=floors['take_ms'],
        l2_tb_per_s=floors['l2_tb_per_s'], take_bytes=floors['take_bytes'],
        plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms))
    return rows


def inv_rows(torch, gen, first):
    from tnco_tpu_torch.kernels import scatter as ks
    rows = []
    for b, q, n in ((cs.B, 2 * cs.P, cs.N_PAD), (cs.B, 777, 20000)):
        ids = cs._rand_ids(torch, gen, b, q, n)
        ids[:, q // 2:] = ids[:, :q - q // 2]
        want = ks.inv_ids_plain(ids, n)
        inv = torch.empty_like(want)
        _call(torch, first, 'tnco_inv_ids_first', ids.data_ptr(),
              inv.data_ptr(), b, n, q)
        if not torch.equal(inv, want) or not torch.equal(
                ks.inv_ids(ids, n), want):
            raise SystemExit(f'FAIL: inv_ids != plain at n={n}')
        t_first, t_new = _in_turns(
            torch,
            lambda: _call(torch, first, 'tnco_inv_ids_first', ids.data_ptr(),
                          inv.data_ptr(), b, n, q),
            lambda: ks.inv_ids(ids, n))
        slices_ms = {}
        for width in (1024, 4096):
            inv.zero_()
            ks._launch_inv(ids, inv, width)
            if not torch.equal(inv, want):
                raise SystemExit(f'FAIL: inv_ids slice {width} != plain')
            slices_ms[width] = cs._time_ms(
                torch, lambda: ks._launch_inv(ids, inv, width))
        blocks = b * ks.inv_slices(n)
        floor = cs._time_ms(torch, lambda: _call(
            torch, first, 'tnco_empty_floor', blocks, 256))
        floor_first = cs._time_ms(torch, lambda: _call(
            torch, first, 'tnco_empty_floor', b, 256))
        ok = (ids >= 0) & (ids < n)
        safe = torch.where(ok, ids, n).long()
        qi = torch.arange(q, device='cuda',
                          dtype=torch.int32).expand(b, q).contiguous()
        buf = torch.full((b, n + 1), -1, dtype=torch.int32, device='cuda')
        lib_ms = cs._time_ms(torch, lambda: buf.scatter_reduce_(
            1, safe, qi, 'amax'))
        plain_ms = cs._time_ms(torch, lambda: ks.inv_ids_plain(ids, n))
        rows.append(dict(
            name='K2', shape=f'B={b} Q={q} n={n}', blocks=blocks,
            slice=ks.INV_SLICE, other_slices_ms=slices_ms,
            first_ms=t_first, new_ms=t_new, floor_ms=floor,
            first_grid_floor_ms=floor_first, plain_ms=plain_ms,
            library_ms=lib_ms,
            bound_ms=1e3 * 4 * (b * q + b * n) / cs.HBM_BYTES_PER_S))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print('profile_torch_probe_inv: needs a CUDA card', file=sys.stderr)
        return 2
    from tnco_tpu_torch.device import card_info
    from tnco_tpu_torch.kernels import build
    card = ', '.join(card_info(torch.device('cuda')).values())
    print(f'card: {card}', flush=True)
    build.load()
    for line in build.build_log.splitlines():
        if 'probe' in line or 'inv_ids' in line or 'registers' in line or \
                'spill' in line:
            print(f'  ptxas: {line.strip()}')
    first = cs.probe_inv_baseline_lib()
    gen = torch.Generator(device='cuda')
    gen.manual_seed(args.seed)
    rows = probe_rows(torch, gen, first) + inv_rows(torch, gen, first)
    for r in rows:
        extra = ''
        if 'row_ops' in r:
            best = min(r['new_ms'])
            extra = f", {1e6 * best / r['row_ops']:.4f} ns/row op"
        print(f"{r['name']} ({r['shape']}): first {r['first_ms']} ms, new "
              f"{r['new_ms']} ms{extra}; floor {r['floor_ms']:.5f} ms, "
              f"bound {r['bound_ms']:.5f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']}", flush=True)
        for s in r.get('sweep', ()):
            print(f"  loop sweep: {s['cols']} columns, {s['pairs']} pairs x "
                  f"{s['threads']} threads ({s['blocks']} blocks): "
                  f"{s['ms']:.5f} ms, "
                  f"barrier floor {s['barrier_floor_ms']:.5f} ms")
        for v in r.get('pipelined_variant', ()):
            print(f"  loop {v['cols']} columns, {v['pairs']} pairs: "
                  f"{v['kept_ms']} ms, next ids in the write phase "
                  f"{v['pipelined_ms']} ms (in turns)")
        if 'global_route_ms' in r:
            print(f"  loop global route: {r['global_route_ms']:.4f} ms")
        if 'l2_tb_per_s' in r:
            print(f"  L2 read rate {r['l2_tb_per_s']:.3f} TB/s")
        if 'other_slices_ms' in r:
            print(f"  other slice widths: {r['other_slices_ms']} (kept "
                  f"{r['slice']})")
        if 'first_grid_floor_ms' in r:
            print(f"  empty kernel on the first design's grid "
                  f"{r['first_grid_floor_ms']:.5f} ms")
    result = {'card': card, 'rows': rows}
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + '\n')
    print(line)
    return 0


if __name__ == '__main__':
    sys.exit(main())

#!/usr/bin/env python3
"""Times the row gather K1 and the in-place row scatter K3 against their
first design, in turns, on one GPU.

Builds the kernels (``tnco_tpu_torch/csrc``) and their first design
(``scripts/gather_scatter_first_design.cu``: the first K1, K2 and K3
under other entry-point names, and the sorted variant of the new K1's
sparse route) into ``build/kernels/``, then:

- at the main path's shapes (Sycamore m=20 at B=64, P=128: the walks
  engine's index gather, the plane slicer's row window and sorted-space
  gathers, two small pulls; the merged {B, A} apply and the par apply,
  and the merged apply's writes at contiguous columns as a control for
  the cost of random partial-sector writes) checks every route of
  the new kernels and the first design bitwise against the plain
  versions, then times the first design and the new kernel in turns
  (first, new, new, first), and each other route of K1 (and the sorted
  variant, where Q <= 1024) after them.  The first design of the scatter
  is its whole call, K2 then K3, as the wrapper launched them.  A copy
  of the index gather's 64 planes gives the card's streaming rate beside
  them;
- unless ``--no-sweep``, times K1's sparse and row routes on G=64 planes
  of B=64 rows of N words at Q ids, over a grid of N and Q: the numbers
  that set the wrapper's route threshold (``kernels/gather.py``:
  ``ROW_MAX_N``, ``ROW_MIN_Q``).

Times are device ms per call: 50 calls in one CUDA graph, median of 11
replays (``chip_smoke._time_ms``).  Each row also has the word bound and
the 32-byte sectors that the access pattern touches (``chip_smoke``'s
``_gather_traffic`` and ``_scatter_traffic``) over 3.35 TB/s.

Run from the repository root:

    python3 scripts/profile_torch_gather_scatter.py [--no-sweep]
        [--seed 0] [--out FILE.json]

Prints a summary and one JSON line; ``--out`` also writes the JSON.
"""

import argparse
import ctypes
import json
from pathlib import Path
import sys

_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(_ROOT))

import chip_smoke as cs  # noqa: E402

FIRST_DESIGN = Path(__file__).resolve().parent / \
    'gather_scatter_first_design.cu'
_P, _I = ctypes.c_void_p, ctypes.c_int
FIRST_SIGNATURES = {
    'tnco_gather_gbn_first': (_P, _P, _P, _I, _I, _I, _I, _P),
    'tnco_inv_ids_first': (_P, _P, _I, _I, _I, _P),
    'tnco_scatter_rows_first': (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    'tnco_gather_sorted_variant': (_P, _P, _P, _I, _I, _I, _I, _P),
}
SORT_MAX_Q = 1024   # the sorted variant's limit
B, P, W, N = cs.B, cs.P, cs.W, cs.N_PAD
F = 2 * W + 5
SWEEP_N = (64, 256, 512, 1024, 2048, 3328)
SWEEP_Q = (128, 640, 1024, 2048, 4096)


def _first_lib():
    from tnco_tpu_torch.kernels import build
    path = build.build((str(FIRST_DESIGN),), (),
                       'libtnco_gather_scatter_first.so')
    return build._bind(path, FIRST_SIGNATURES)


def _stream(torch):
    return torch.cuda.current_stream().cuda_stream


def _gather_first(torch, lib, vals, ids, out, lo,
                  entry='tnco_gather_gbn_first'):
    """A K1 launch of the first design (or, by ``entry``, of the sorted
    variant)."""
    _, b, n = vals.shape
    g, _, q = out.shape
    rc = getattr(lib, entry)(vals.data_ptr() + lo * b * n * 4,
                             ids.data_ptr(), out.data_ptr(), g, b, n, q,
                             _stream(torch))
    if rc:
        raise RuntimeError(f'{entry} failed ({rc})')


def _scatter_first(torch, lib, vals, ids, inv, upd, lo, hi):
    """The first design's call: K2 into ``inv``, then K3."""
    _, b, n = vals.shape
    q = ids.shape[1]
    rc = lib.tnco_inv_ids_first(ids.data_ptr(), inv.data_ptr(), b, n, q,
                                _stream(torch))
    rc = rc or lib.tnco_scatter_rows_first(
        vals.data_ptr() + lo * b * n * 4, ids.data_ptr(), inv.data_ptr(),
        upd.data_ptr(), hi - lo, b, n, q, _stream(torch))
    if rc:
        raise RuntimeError(f'first-design scatter failed ({rc})')


def _words(torch, gen, shape):
    return torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                         device='cuda', dtype=torch.int32)


def _row(name, shape, word_bytes, sector_bytes, **ms):
    return dict(name=name, shape=shape,
                bound_ms=1e3 * word_bytes / cs.HBM_BYTES_PER_S,
                sector_ms=1e3 * sector_bytes / cs.HBM_BYTES_PER_S,
                word_bytes=word_bytes, sector_bytes=sector_bytes, **ms)


def gather_shapes(torch, gen, first):
    """K1 at the main path's shapes: checks, then times in turns."""
    from tnco_tpu_torch.kernels import gather as kg
    from tnco_tpu_torch.testing.kernel_cases import gather_routes
    state = _words(torch, gen, (F, B, N))
    rows_wb = _words(torch, gen, (128, B, W))
    word_q = torch.randint(0, W, (B, 32 * W), generator=gen, device='cuda',
                           dtype=torch.int32)
    shapes = (
        ('walks index', state, (0, W),
         cs._rand_ids(torch, gen, B, 5 * P, 3241, frac_high=0.0)),
        ('slicer window', state, (0, W),
         cs._rand_ids(torch, gen, B, 128, 3241, frac_high=0.0)),
        ('slicer sorted', rows_wb, (0, 128), word_q),
        ('pull rows', state, (2 * W, F),
         cs._rand_ids(torch, gen, B, P, 3241, frac_high=0.0)),
        ('pull par', state, (F - 1, F),
         cs._rand_ids(torch, gen, B, 2 * P, 3241, frac_high=0.0)),
    )
    rows = []
    for name, vals, (lo, hi), ids in shapes:
        n, q = vals.shape[2], ids.shape[1]
        want = kg.gather_plain(vals, ids, (lo, hi))
        out = torch.empty_like(want)
        routes = gather_routes(n, q)
        for route in routes:
            out.zero_()
            kg._launch(vals, ids, out, lo, route)
            if not torch.equal(out, want):
                raise SystemExit(f'FAIL: K1 {route} != plain at {name}')
        for entry in ('tnco_gather_gbn_first', 'tnco_gather_sorted_variant'):
            if entry.endswith('variant') and q > SORT_MAX_Q:
                continue
            out.zero_()
            _gather_first(torch, first, vals, ids, out, lo, entry)
            if not torch.equal(out, want):
                raise SystemExit(f'FAIL: {entry} != plain at {name}')
        route = kg.gather_route(n, q)
        t_first, t_new = [], []
        for order in ('first', 'new', 'new', 'first'):
            if order == 'first':
                t_first.append(cs._time_ms(torch, lambda: _gather_first(
                    torch, first, vals, ids, out, lo)))
            else:
                t_new.append(cs._time_ms(torch, lambda: kg._launch(
                    vals, ids, out, lo, route)))
        others = {r: cs._time_ms(torch, lambda: kg._launch(
            vals, ids, out, lo, r)) for r in routes if r != route}
        if q <= SORT_MAX_Q:
            others['sorted'] = cs._time_ms(torch, lambda: _gather_first(
                torch, first, vals, ids, out, lo,
                'tnco_gather_sorted_variant'))
        safe = ids.clamp(0, n - 1).long()[None].expand(hi - lo, -1, -1)
        v0 = vals[lo:hi]
        lib_ms = cs._time_ms(torch, lambda: torch.gather(v0, 2, safe))
        plain_ms = cs._time_ms(torch, lambda: kg.gather_plain(
            vals, ids, (lo, hi)))
        words, sectors = cs._gather_traffic(torch, ids, n, lo, hi - lo, B)
        rows.append(_row(f'K1 {name}', f'G={hi - lo} B={B} N={n} Q={q}',
                         words, sectors, route=route, first_ms=t_first,
                         new_ms=t_new, other_routes_ms=others,
                         plain_ms=plain_ms, library_ms=lib_ms))
    return rows


def scatter_shapes(torch, gen, first):
    """The K3 call at the walks engine's two applies, and the merged
    apply's writes at the first P columns of every row."""
    from tnco_tpu_torch.kernels import scatter as ks
    rows = []
    q = torch.arange(2 * P, device='cuda', dtype=torch.int32)
    contiguous = torch.where(q < P, q, -1).expand(B, -1).contiguous()
    for name, (lo, hi), ids in (
            ('merged apply', (0, F - 1),
             cs._unique_ids(torch, gen, B, 2 * P, 3241)),
            ('par apply', (F - 1, F),
             cs._unique_ids(torch, gen, B, 2 * P, 3241)),
            ('merged apply, contiguous columns', (0, F - 1), contiguous)):
        vals = _words(torch, gen, (F, B, N))
        upd = _words(torch, gen, (hi - lo, B, 2 * P))
        inv = torch.empty((B, N), dtype=torch.int32, device='cuda')
        want = ks.scatter_rows_inplace_plain(vals.clone(), ids, upd,
                                             (lo, hi))
        route = ks.scatter_route(N, 2 * P)
        for r in ('smem', 'global'):
            got = vals.clone()
            ks._launch_scatter(got, ids, upd, lo, hi, r)
            if not torch.equal(got, want):
                raise SystemExit(f'FAIL: K3 {r} != plain at {name}')
        got = vals.clone()
        _scatter_first(torch, first, got, ids, inv, upd, lo, hi)
        if not torch.equal(got, want):
            raise SystemExit(f'FAIL: first-design K2 + K3 != plain at {name}')
        t_first, t_new = [], []
        for order in ('first', 'new', 'new', 'first'):
            if order == 'first':
                t_first.append(cs._time_ms(torch, lambda: _scatter_first(
                    torch, first, got, ids, inv, upd, lo, hi)))
            else:
                t_new.append(cs._time_ms(torch, lambda: ks._launch_scatter(
                    got, ids, upd, lo, hi, route)))
        others = {'global': cs._time_ms(torch, lambda: ks._launch_scatter(
            got, ids, upd, lo, hi, 'global'))}
        plain_ms = cs._time_ms(torch, lambda: ks.scatter_rows_inplace_plain(
            got, ids, upd, (lo, hi)))
        words, sectors = cs._scatter_traffic(torch, ids, N, lo, hi - lo, B)
        rows.append(_row(f'K3 {name}', f'G={hi - lo} B={B} N={N} Q={2 * P}',
                         words, sectors, route=route, first_ms=t_first,
                         new_ms=t_new, other_routes_ms=others,
                         plain_ms=plain_ms, library_ms=None))
    return rows


def stream_copy(torch, gen):
    """A copy of 64 planes of [64, 3328] words: the card's streaming rate
    on the bytes the index gather's rows span (read once, written once)."""
    src = _words(torch, gen, (W, B, N))
    dst = torch.empty_like(src)
    ms = cs._time_ms(torch, lambda: dst.copy_(src))
    nbytes = 2 * 4 * src.numel()
    return dict(name='copy', shape=f'{W} planes of [{B}, {N}]', ms=ms,
                bytes=nbytes, tb_per_s=nbytes / ms / 1e9)


def sweep(torch, gen):
    """K1's routes on G=64 planes of B=64 rows over a grid of N and Q."""
    from tnco_tpu_torch.kernels import gather as kg
    from tnco_tpu_torch.testing.kernel_cases import gather_routes
    g = 64
    rows = []
    for n in SWEEP_N:
        vals = _words(torch, gen, (g, B, n))
        for q in SWEEP_Q:
            ids = cs._rand_ids(torch, gen, B, q, n, frac_high=0.0)
            out = torch.empty((g, B, q), dtype=torch.int32, device='cuda')
            ms = {r: cs._time_ms(torch, lambda: kg._launch(
                vals, ids, out, 0, r)) for r in gather_routes(n, q)}
            words, sectors = cs._gather_traffic(torch, ids, n, 0, g, B)
            rows.append(_row('K1 sweep', f'G={g} B={B} N={n} Q={q}', words,
                             sectors, n=n, q=q, route=kg.gather_route(n, q),
                             routes_ms=ms))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--no-sweep', action='store_true')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print('profile_torch_gather_scatter: needs a CUDA card',
              file=sys.stderr)
        return 2
    from tnco_tpu_torch.device import card_info
    from tnco_tpu_torch.kernels import build
    card = ', '.join(card_info(torch.device('cuda')).values())
    print(f'card: {card}', flush=True)
    build.load()
    for line in build.build_log.splitlines():
        if 'gather' in line or 'scatter' in line or 'registers' in line or \
                'spill' in line:
            print(f'  ptxas: {line.strip()}')
    first = _first_lib()
    gen = torch.Generator(device='cuda')
    gen.manual_seed(args.seed)
    rows = gather_shapes(torch, gen, first) + scatter_shapes(torch, gen,
                                                             first)
    copy = stream_copy(torch, gen)
    print(f"copy {copy['shape']}: {copy['ms']:.4f} ms, {copy['bytes']} B, "
          f"{copy['tb_per_s']:.3f} TB/s", flush=True)
    for r in rows:
        others = ', '.join(f'{k} {v:.4f}' for k, v in
                           r['other_routes_ms'].items())
        print(f"{r['name']} ({r['shape']}, route {r['route']}): first "
              f"{r['first_ms']} ms, new {r['new_ms']} ms; other routes "
              f"[{others}]; plain {r['plain_ms']:.4f}, library "
              f"{r['library_ms']}; bound {r['bound_ms']:.4f} ms, sectors "
              f"{r['sector_ms']:.4f} ms ({r['sector_bytes']} B)", flush=True)
    if not args.no_sweep:
        sw = sweep(torch, gen)
        for r in sw:
            ms = ', '.join(f'{k} {v:.4f}' for k, v in r['routes_ms'].items())
            print(f"sweep N={r['n']} Q={r['q']}: {ms} (wrapper: "
                  f"{r['route']}); bound {r['bound_ms']:.4f}, sectors "
                  f"{r['sector_ms']:.4f} ms")
        rows += sw
    result = {'card': card, 'rows': rows, 'copy': copy}
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + '\n')
    print(line)
    return 0


if __name__ == '__main__':
    sys.exit(main())

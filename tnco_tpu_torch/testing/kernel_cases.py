"""Card checks of the row gather K1, the id inversion K2, the in-place
row scatter K3 and the row-read probe P1: the main path's shapes and
edge cases, each run by every route of the kernel that takes it and by
the wrapper, bitwise against the plain version.

``tests/test_torch_kernels.py`` and ``tests/test_torch_gather_probe.py``
(marked ``cuda``) and ``chip_smoke.py`` phase 2 run the same cases.
Inputs are made with numpy from a seed; every id row holds -1, ids >= N
and in-range duplicates, and float32 vals hold NaN payloads, infinities
and -0.
"""

from contextlib import contextmanager
from typing import NamedTuple

import numpy as np
import torch

from tnco_tpu_torch.benchmarks import gather_probe as gp
from tnco_tpu_torch.kernels import gather as kg
from tnco_tpu_torch.kernels import scatter as ks

__all__ = ['GatherCase', 'ScatterCase', 'InvCase', 'ProbeCase',
           'GATHER_CASES', 'SCATTER_CASES', 'INV_CASES', 'PROBE_CASES',
           'gather_routes', 'scatter_routes', 'loop_routes',
           'check_gather', 'check_scatter', 'check_inv', 'check_probe',
           'probe_ids', 'recorded_cases']

# Sycamore m=20 at B=64, P=128: W=64 index planes, N padded to 3328; the
# walks engine's packed state has F = 2W+5 planes (index, union, c0, c1,
# lcc, width, par).
_B, _P, _W, _N = 64, 128, 64, 3328
_F = 2 * _W + 5
# The lockstep 'batched' engines on Sycamore m=20 at the app's default
# fuse (N=855, W=26): the FW sweep state has W + 5 planes (index, c0,
# c1, par, lcc, width); par is plane W + 2.
_BW, _BN = 26, 855
_BF, _BPAR = _BW + 5, _BW + 2
# The row route's shared memory for one row (csrc/gather.cu:
# kRowSmemBytes).
_ROW_SMEM_BYTES = 32 * 1024
_SPECIALS = np.asarray([0x7FC00000, 0xFF800000, 0x7F800000, 0x80000000,
                        0x7F800001, 0x7FBFFFFF], dtype=np.uint32)


class GatherCase(NamedTuple):
    name: str
    g: int             # planes of vals
    b: int
    n: int
    planes: tuple      # (lo, hi), or None for all planes
    q: int
    route: str         # the wrapper's route, gather_route(n, q)


class ScatterCase(NamedTuple):
    name: str
    g: int
    b: int
    n: int
    planes: tuple
    q: int
    dup: bool          # duplicate and out-of-range ids besides the -1s
    route: str         # scatter_route(n, q)


GATHER_CASES = (
    # The walks engine: the index gather at {B, A, C, c0(B), c1(B)}, the
    # par pull at the walks and fresh leaves, the scalar rows at B.
    GatherCase('walks index', _F, _B, _N, (0, _W), 5 * _P, 'sparse'),
    GatherCase('pull par', _F, _B, _N, (_F - 1, _F), 2 * _P, 'sparse'),
    GatherCase('pull rows', _F, _B, _N, (2 * _W, _F), _P, 'sparse'),
    # The plane slicer: over-width rows in windows of 128, the sorted-space
    # gather of [K=128, B, w] rows at [B, nbp] word ids, the lane bits.
    GatherCase('slicer window', _F, _B, _N, (0, _W), 128, 'sparse'),
    GatherCase('slicer sorted', 128, _B, _W, None, 2048, 'row'),
    GatherCase('slicer lanes', 1, _B, 2048, None, 2048, 'row'),
    # The union planes and the slice-aware costs (Q = N).
    GatherCase('union', _F, _B, _N, (0, _W), _N, 'sparse'),
    # The lockstep engines: a walk step's rows of b and a (all planes,
    # one id), the index rows of c and b's children, the parent reads.
    GatherCase('batched rows', _BF, _B, _BN, None, 1, 'sparse'),
    GatherCase('batched index', _BF, _B, _BN, (0, _BW), 3, 'sparse'),
    GatherCase('batched par', _BF, _B, _BN, (_BPAR, _BPAR + 1), 1,
               'sparse'),
    # Ragged N and Q (Q % 4 != 0 takes the one-word form), N above the row
    # route's shared memory, B = Q = G = 1, tiny rows with lo > 0.  Every
    # case also runs the route the wrapper does not take, where it fits.
    GatherCase('ragged 3241', 8, _B, 3241, (2, 7), 641, 'sparse'),
    GatherCase('ragged 100', 9, _B, 100, (1, 9), 2050, 'row'),
    GatherCase('large rows', 3, 4, 20000, None, 20000, 'sparse'),
    GatherCase('single', 1, 1, _N, None, 1, 'sparse'),
    GatherCase('tiny', 3, 2, 5, (1, 3), 17, 'sparse'),
)

SCATTER_CASES = (
    # The walks engine's two applies: the merged {B, A} planes and par.
    ScatterCase('merged apply', _F, _B, _N, (0, _F - 1), 2 * _P, False,
                'smem'),
    ScatterCase('par apply', _F, _B, _N, (_F - 1, _F), 2 * _P, False,
                'smem'),
    ScatterCase('duplicates', _F, _B, _N, (3, 40), 2 * _P, True, 'smem'),
    # The lockstep engines' two writes: rows a and b over every plane,
    # par at c and e.
    ScatterCase('batched rows', _BF, _B, _BN, None, 2, False, 'smem'),
    ScatterCase('batched par', _BF, _B, _BN, (_BPAR, _BPAR + 1), 2, False,
                'smem'),
    ScatterCase('ragged 3241', 6, _B, 3241, (1, 6), 2 * _P, True, 'smem'),
    ScatterCase('ragged 100', 4, 3, 100, None, 300, True, 'smem'),
    # N whose winner map does not fit shared memory.
    ScatterCase('large rows', 3, 8, 20000, (1, 3), 777, True, 'global'),
    ScatterCase('single', 1, 1, _N, None, 1, False, 'smem'),
)


class InvCase(NamedTuple):
    name: str
    b: int
    n: int
    q: int
    dup: bool          # the second half of each row repeats the first


_S = ks.INV_SLICE
INV_CASES = (
    # The bench's K4 call (ids [64, 256] -> [64, 3328]) and its duplicates.
    InvCase('main', _B, _N, 2 * _P, False),
    InvCase('duplicates', _B, _N, 2 * _P, True),
    # Slice edges: one word, one slice less or more one word, ragged n.
    InvCase('n=1', _B, 1, 2 * _P, True),
    InvCase('slice - 1', _B, _S - 1, 2 * _P, True),
    InvCase('slice + 1', _B, _S + 1, 2 * _P, True),
    InvCase('ragged 3241', _B, 3241, 2 * _P, True),
    # The first design's global-map size, Q = n, and Q > n.
    InvCase('large rows', _B, 20000, 777, True),
    InvCase('Q = n = 2048', _B, 2048, 2048, False),
    InvCase('Q > n', 8, 100, 300, False),
)


class ProbeCase(NamedTuple):
    name: str
    n: int
    p: int
    rounds: int
    heavy: bool        # every round's ids drawn from 4 distinct rows


PROBE_CASES = tuple(
    ProbeCase(f'N={n} P={p} R={r}', n, p, r, False)
    for n in (_N, 3241, 40)
    for p, r in ((128, 256), (1, 1), (129, 7), (gp.MAX_LOOP_P, 3))) + (
    ProbeCase('N=40 P=8 R=3', 40, 8, 3, False),
    ProbeCase('heavy duplicates', _N, 128, 256, True),
    # Above the smem route's limit: the global route only.
    ProbeCase('large N', 60000, 128, 2, False),
)


def gather_routes(n: int, q: int) -> tuple:
    """Every route of K1 that takes rows of ``n`` words at ``q`` ids."""
    return ('sparse', 'row') if 4 * ((n + 4) & ~3) <= _ROW_SMEM_BYTES \
        else ('sparse',)


def scatter_routes(n: int, q: int) -> tuple:
    """Every route of K3 that takes ``q`` ids into rows of ``n`` words."""
    return ('smem', 'global') if ks.scatter_route(n, q) == 'smem' else \
        ('global',)


def loop_routes(n: int, p: int) -> tuple:
    """Every route of the probe's loop kernel at N = ``n``, P = ``p``."""
    return ('smem', 'global') if gp.loop_route(n, p) == 'smem' else \
        ('global',)


def _words(r, shape, dtype):
    x = r.integers(0, 2**32, shape, dtype=np.uint32)
    if dtype == torch.float32:
        k = min(x.size, len(_SPECIALS))
        x.reshape(-1)[:k] = _SPECIALS[:k]
    return torch.from_numpy(x.view(np.int32)).view(dtype)


def _ids(r, b, q, n):
    """-1, n and n + 5 among in-range ids (duplicates where q > n)."""
    ids = r.integers(0, n, (b, q)).astype(np.int32)
    u = r.random((b, q))
    ids[u < 0.1] = -1
    ids[u > 0.95] = n
    ids[(u > 0.9) & (u <= 0.95)] = n + 5
    return torch.from_numpy(ids)


def _unique_ids(r, b, q, n, dup):
    """Kept-walk ids: distinct in-range ids, -1 for about half; with
    ``dup``, the second half repeats the first and two ids are >= n."""
    ids = np.full((b, q), -1, np.int32)
    for i in range(b):
        k = min(q, n)
        ids[i, :k] = r.permutation(n)[:k]
    ids[r.random((b, q)) < 0.5] = -1
    if dup and q > 1:
        ids[:, q // 2:] = ids[:, :q - q // 2]
        ids[:, 0] = n
        ids[:, q - 1] = n + 3
    return torch.from_numpy(ids)


def _same(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def check_gather(case, dtype, device, seed=0):
    """Runs one K1 case by every route and by the wrapper; returns the
    routes that differ from the plain version (empty when all agree)."""
    r = np.random.default_rng(seed)
    vals = _words(r, (case.g, case.b, case.n), dtype).to(device)
    ids = _ids(r, case.b, case.q, case.n).to(device)
    want = kg.gather_plain(vals, ids, case.planes)
    lo = 0 if case.planes is None else case.planes[0]
    bad = []
    for route in gather_routes(case.n, case.q):
        out = torch.empty_like(want)
        kg._launch(vals, ids, out, lo, route)
        if not _same(out, want):
            bad.append(route)
    if not _same(kg.gather_gbn(vals, ids, planes=case.planes), want):
        bad.append('wrapper')
    return bad


def check_scatter(case, dtype, device, seed=0):
    """Runs one K3 case by every route and by the wrapper on copies of one
    tensor; returns the routes that differ from the plain version."""
    r = np.random.default_rng(seed)
    vals = _words(r, (case.g, case.b, case.n), dtype).to(device)
    lo, hi = (0, case.g) if case.planes is None else case.planes
    ids = _unique_ids(r, case.b, case.q, case.n, case.dup).to(device)
    upd = _words(r, (hi - lo, case.b, case.q), dtype).to(device)
    want = ks.scatter_rows_inplace_plain(vals.clone(), ids, upd,
                                         case.planes)
    bad = []
    for route in scatter_routes(case.n, case.q):
        got = vals.clone()
        ks._launch_scatter(got, ids, upd, lo, hi, route)
        if not _same(got, want):
            bad.append(route)
    got = vals.clone()
    if ks.scatter_rows_inplace(got, ids, upd, planes=case.planes) is not \
            got or not _same(got, want):
        bad.append('wrapper')
    return bad


def _inv_ids(r, case):
    ids = _ids(r, case.b, case.q, case.n).numpy()
    if case.dup and case.q > 1:
        ids[:, case.q // 2:] = ids[:, :case.q - case.q // 2]
    if case.q > 3:
        ids[:, 2] = -2**31
        ids[:, 3] = 2**31 - 1
    return torch.from_numpy(ids)


@contextmanager
def recorded_cases():
    """Records the shape of every K1 and K3 launch made inside the block.

    Yields a set that fills with one ``(case, dtype)`` pair for each
    distinct shape (a :class:`GatherCase` or :class:`ScatterCase` with the
    launch's planes, Q and route), for :func:`check_gather` and
    :func:`check_scatter` to hold the kernels at the shapes a path gave
    them.  The launches themselves are unchanged.
    """
    seen = set()
    launch, launch_scatter = kg._launch, ks._launch_scatter

    def gather(vals, ids, out, lo, route):
        g, b, n = vals.shape
        planes, q = (lo, lo + out.shape[0]), ids.shape[1]
        seen.add((GatherCase(f'G={g} B={b} N={n} planes={planes} Q={q}',
                             g, b, n, planes, q, route), vals.dtype))
        launch(vals, ids, out, lo, route)

    def scatter(vals, ids, upd, lo, hi, route):
        g, b, n = vals.shape
        q = ids.shape[1]
        seen.add((ScatterCase(f'G={g} B={b} N={n} planes={(lo, hi)} Q={q}',
                              g, b, n, (lo, hi), q, False, route),
                  vals.dtype))
        launch_scatter(vals, ids, upd, lo, hi, route)

    kg._launch, ks._launch_scatter = gather, scatter
    try:
        yield seen
    finally:
        kg._launch, ks._launch_scatter = launch, launch_scatter


def check_inv(case, device, seed=0):
    """Runs one K2 case through the wrapper; returns ['wrapper'] when it
    differs from the plain version (empty when they agree)."""
    r = np.random.default_rng(seed)
    ids = _inv_ids(r, case).to(device)
    want = ks.inv_ids_plain(ids, case.n)
    return [] if torch.equal(ks.inv_ids(ids, case.n), want) else ['wrapper']


def probe_ids(r, n, p, rounds, heavy):
    """[R, P] int32 ids in [0, n) with repeats (within a round at random;
    with ``heavy``, every round's ids drawn from 4 distinct rows)."""
    if heavy:
        rows = r.choice(n, size=min(4, n), replace=False)
        return rows[r.integers(0, len(rows), (rounds, p))].astype(np.int32)
    return r.integers(0, n, (rounds, p)).astype(np.int32)


def check_probe(case, device, seed=0):
    """Runs one P1 case by every route of the loop kernel, and both impls
    through the wrapper; returns the routes that differ from the plain
    version or changed the caller's state."""
    r = np.random.default_rng(seed)
    state = torch.from_numpy(
        r.integers(-2**31, 2**31, (case.n, gp.COLS)).astype(np.int32))
    state = state.to(device)
    ids = torch.from_numpy(probe_ids(r, case.n, case.p, case.rounds,
                                     case.heavy)).to(device)
    before = state.clone()
    want = gp.probe_plain(state, ids, 'loop')
    bad = []
    for route in loop_routes(case.n, case.p):
        out = torch.empty_like(want)
        gp._launch_loop(state, ids, out, route)
        if not torch.equal(out, want) or not torch.equal(state, before):
            bad.append(f'loop {route}')
    for impl in gp.IMPLS:
        got = gp.probe(state, ids, impl)
        if not torch.equal(got, gp.probe_plain(state, ids, impl)) or \
                not torch.equal(state, before):
            bad.append(f'{impl} wrapper')
    return bad

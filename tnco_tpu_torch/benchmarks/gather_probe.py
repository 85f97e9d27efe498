"""P1: the row-read probe — the port of ``benchmarks/pallas_gather_probe.py``.

It times dynamic row reads and writes on a Sycamore-sized ``[3328, 128]``
int32 state, the access pattern of the walker kernel (K5), whose walks
read and write whole node rows at data-dependent ids:

- ``'loop'``: R rounds; round r reads the P rows ``state[ids[r, i]]``
  into a scratch in order, then writes ``state[ids[r, i]] = scratch[i] +
  1`` in order (a repeated id: the last i wins); returns the last round's
  scratch ``[P, 128]``.  The caller's state is not modified.
- ``'take'``: ``out[p] = sum over r of state[ids[r, p]]``, int32
  wrapping.

Ids lie in ``[0, N)``; both impls clamp them to that range.  A CUDA
tensor goes to the hand-written kernels (``csrc/probe.cu``); a CPU tensor
to :func:`probe_plain`.  ``'loop'`` has two routes, picked from ``(N, P)``
by :func:`loop_route`: ``'smem'`` (one block per column of the state,
each keeping its column of all N rows in shared memory) and ``'global'``
(one block over a working copy in global memory, for N too large for one
column in a block).  No fallback: a CUDA call launches the kernel or
raises, and unlike the JAX script the probe catches nothing, so a kernel
that fails makes the run fail.

Usage::

    python -m tnco_tpu_torch.benchmarks.gather_probe [P] [ROUNDS] [--device cpu]

It prints the card's name and power limit, then one line per impl:
``loop: X ms for Y row ops -> Z ns/row`` (``loop`` does 2 R P row ops,
``take`` R P).  On the card the times are device times between CUDA
events.
"""

import argparse
import time

import numpy as np
import torch

from tnco_tpu_torch.device import card_info, resolve_device
from tnco_tpu_torch.kernels import build
from tnco_tpu_torch.kernels.scatter import inv_ids_plain
from tnco_tpu_torch.utils.profiling import count

__all__ = ['probe', 'probe_plain', 'main', 'IMPLS', 'loop_route',
           'loop_threads', 'loop_stage_rounds']

IMPLS = ('loop', 'take')
COLS = 128
N_ROWS = 3328
# Shared memory a block can use (bytes).
SMEM_BYTES = 232448
# The loop's global route keeps its [P, 128] int32 scratch in one block's
# shared memory; the contract holds for both routes.
MAX_LOOP_P = SMEM_BYTES // (COLS * 4)
# The loop's smem route (csrc/probe.cu) keeps one column of all N rows
# and two stage buffers of ids (a whole number of rounds, at least one, in
# at most STAGE_WORDS words each) in a block's shared memory.  This module
# picks the launch (route, threads, rounds a stage) and passes it.
STAGE_WORDS = 2048


def _check(state, ids, impl):
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}.")
    if state.dim() != 2 or state.shape[1] != COLS or \
            state.dtype != torch.int32 or not state.is_contiguous() or \
            state.shape[0] == 0:
        raise ValueError(f"state must be a contiguous int32 [N, {COLS}] "
                         f"tensor, got {tuple(state.shape)} {state.dtype}.")
    if ids.dim() != 2 or ids.dtype != torch.int32 or \
            not ids.is_contiguous() or ids.shape[1] == 0:
        raise ValueError("ids must be a contiguous int32 [R, P] tensor, "
                         f"got {tuple(ids.shape)} {ids.dtype}.")
    if ids.device != state.device:
        raise ValueError(f"state on {state.device}, ids on {ids.device}.")
    if state.device.type not in ('cpu', 'cuda'):
        raise ValueError(f"Unsupported device: {state.device}.")
    if impl == 'loop' and not (ids.shape[0] >= 1 and
                               ids.shape[1] <= MAX_LOOP_P):
        raise ValueError(f"'loop' needs R >= 1 and P <= {MAX_LOOP_P}, got "
                         f"R={ids.shape[0]}, P={ids.shape[1]}.")


def loop_stage_rounds(p: int) -> int:
    """Rounds of ids in each stage buffer of the loop's smem route."""
    return max(1, STAGE_WORDS // p)


def loop_threads(p: int) -> int:
    """Threads of a smem-route block: one a pair, in whole warps."""
    return -(-p // 32) * 32


def loop_route(n: int, p: int) -> str:
    """The loop kernel's route: 'smem' where a column of ``n`` rows and
    the stage buffers fit a block's shared memory (N <= 54016 at P =
    128), else 'global'."""
    words = n + 2 * loop_stage_rounds(p) * p
    return 'smem' if 4 * words <= SMEM_BYTES else 'global'


def probe_plain(state, ids, impl: str):
    """Plain PyTorch version of :func:`probe` (the CPU route, and the
    kernels' yardstick on the card)."""
    _check(state, ids, impl)
    n = state.shape[0]
    safe = ids.clamp(0, n - 1)
    if impl == 'take':
        # sum(dtype=int32): torch's default integer sum widens to int64.
        return state[safe.long()].sum(0, dtype=torch.int32)
    work = state.clone()
    for r in range(ids.shape[0]):
        scratch = work[safe[r].long()]
        # Ordered writes: the last i of a repeated id wins.
        inv = inv_ids_plain(safe[r][None], n)[0]
        new = scratch[inv.clamp(min=0).long()] + 1
        work = torch.where((inv >= 0)[:, None], new, work)
    return scratch


def probe(state, ids, impl: str):
    """``state int32 [N, 128]``, ``ids int32 [R, P]`` -> ``int32 [P,
    128]`` (see the module docstring for ``impl``)."""
    _check(state, ids, impl)
    if state.device.type == 'cpu':
        return probe_plain(state, ids, impl)
    (rounds, p), n = ids.shape, state.shape[0]
    out = torch.empty((p, COLS), dtype=torch.int32, device=state.device)
    if impl == 'loop':
        _launch_loop(state, ids, out, loop_route(n, p))
        count('launches.probe_loop')
    else:
        if state.data_ptr() % 16:
            raise ValueError("'take' reads 16-byte rows: the state's data "
                             "must be 16-byte aligned on the card.")
        lib = build.load()
        stream = torch.cuda.current_stream(state.device).cuda_stream
        rc = lib.tnco_probe_take(ids.data_ptr(), state.data_ptr(),
                                 out.data_ptr(), n, p, rounds, stream)
        build.check(rc, 'probe_take')
        count('launches.probe_take')
    return out


def _launch_loop(state, ids, out, route):
    """One loop-kernel launch by ``route`` (no counting; the wrapper
    counts, and timing code calls this directly)."""
    (rounds, p), n = ids.shape, state.shape[0]
    if route == 'smem':
        work, threads, rps = None, loop_threads(p), loop_stage_rounds(p)
    else:
        work, threads, rps = torch.empty_like(state), 0, 0
    lib = build.load()
    stream = torch.cuda.current_stream(state.device).cuda_stream
    rc = lib.tnco_probe_loop(ids.data_ptr(), state.data_ptr(),
                             None if work is None else work.data_ptr(),
                             out.data_ptr(), n, p, rounds, threads, rps,
                             stream)
    build.check(rc, 'probe_loop')


def _time_ms(fn, dev, calls=10, rounds=5):
    """ms per call: ``calls`` calls back to back, median over ``rounds``;
    CUDA events on the card, the host clock on the CPU."""
    fn()
    times = []
    for _ in range(rounds):
        if dev.type == 'cuda':
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(calls):
                fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e) / calls)
        else:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times.append(1e3 * (time.perf_counter() - t0) / calls)
    return sorted(times)[len(times) // 2]


def main(argv=None) -> dict:
    """Runs the probe at ``[P] [ROUNDS]`` (default 128, 256) and prints
    its lines; returns ``{impl: {'ms', 'row_ops', 'ns_per_row'}}``."""
    ap = argparse.ArgumentParser(
        prog='python -m tnco_tpu_torch.benchmarks.gather_probe',
        description='Per-row cost of dynamic row reads and writes.')
    ap.add_argument('p', nargs='?', type=int, default=128)
    ap.add_argument('rounds', nargs='?', type=int, default=256)
    ap.add_argument('--device', default=None,
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_info(dev)
    print(', '.join(card.values()), flush=True)
    rng = np.random.default_rng(0)
    state = torch.from_numpy(rng.integers(0, 1 << 20, (N_ROWS, COLS))
                             .astype(np.int32)).to(dev)
    ids = torch.from_numpy(rng.integers(0, N_ROWS, (args.rounds, args.p))
                           .astype(np.int32)).to(dev)
    res = {}
    for impl in IMPLS:
        ms = _time_ms(lambda: probe(state, ids, impl), dev)
        nrows = args.rounds * args.p * (2 if impl == 'loop' else 1)
        res[impl] = {'ms': ms, 'row_ops': nrows,
                     'ns_per_row': 1e6 * ms / nrows}
        print(f'{impl}: {ms:.4f} ms for {nrows} row ops -> '
              f'{res[impl]["ns_per_row"]:.3f} ns/row', flush=True)
    return res


if __name__ == '__main__':
    main()

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

Ids lie in ``[0, N)``; both routes clamp them to that range.  A CUDA
tensor goes to the hand-written kernels (``csrc/probe.cu``); a CPU tensor
to :func:`probe_plain`.  No fallback: a CUDA call launches the kernel or
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

__all__ = ['probe', 'probe_plain', 'main', 'IMPLS', 'loop_launches',
           'take_launches']

IMPLS = ('loop', 'take')
COLS = 128
N_ROWS = 3328
# The loop kernel keeps its [P, 128] int32 scratch in one SM's shared
# memory (at most 232448 bytes per block).
MAX_LOOP_P = 232448 // (COLS * 4)

# Kernel launches since the last reset (the bench path's proof of route).
loop_launches = 0
take_launches = 0


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
    global loop_launches, take_launches
    _check(state, ids, impl)
    if state.device.type == 'cpu':
        return probe_plain(state, ids, impl)
    (rounds, p), n = ids.shape, state.shape[0]
    out = torch.empty((p, COLS), dtype=torch.int32, device=state.device)
    lib = build.load()
    stream = torch.cuda.current_stream(state.device).cuda_stream
    if impl == 'loop':
        work = torch.empty_like(state)
        rc = lib.tnco_probe_loop(ids.data_ptr(), state.data_ptr(),
                                 work.data_ptr(), out.data_ptr(), n, p,
                                 rounds, stream)
        build.check(rc, 'probe_loop')
        loop_launches += 1
    else:
        rc = lib.tnco_probe_take(ids.data_ptr(), state.data_ptr(),
                                 out.data_ptr(), n, p, rounds, stream)
        build.check(rc, 'probe_take')
        take_launches += 1
    return out


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

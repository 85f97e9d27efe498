"""Generic host-side parallel fan-out (reference ``tnco.parallel`` parity;
the port's copy of ``tnco_tpu/parallel/host.py``).

The reference runs arbitrary per-seed callables over loky processes with
SharedMemory status/stop/metric buffers and a timeout timer
(tnco/parallel.py:38-368).  Device work in this framework batches on the
card instead (see :mod:`tnco_tpu_torch.parallel.replicas`), so this host
fan-out uses threads: the callables it runs are dominated by device
calls or numpy, which release the GIL.  The buffer/stop/timeout contract
matches the reference.
"""

from concurrent.futures import ThreadPoolExecutor
import os
import threading
from typing import Any, Callable

import numpy as np

__all__ = ['Buffer', 'Parallel']


class Buffer:
    """Typed shared array visible to the driver and every worker.

    Reference: the SharedMemory-backed ``Buffer`` (tnco/parallel.py:38-108);
    threads share memory directly, so this is a thin numpy wrapper with the
    same element-typed get/set API.
    """

    def __init__(self, n: int, fmt: str = 'f') -> None:
        dtype = {
            'f': np.float32, 'd': np.float64, 'i': np.int32,
            'q': np.int64, 'b': np.int8, '?': np.bool_
        }.get(fmt)
        if dtype is None:
            raise ValueError(f"Unsupported buffer format: {fmt!r}")
        self._data = np.zeros(n, dtype=dtype)

    def __len__(self) -> int:
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx].item() if np.isscalar(idx) or isinstance(
            idx, int) else self._data[idx]

    def __setitem__(self, idx, value) -> None:
        self._data[idx] = value

    def __iter__(self):
        return iter(self._data)

    @property
    def data(self) -> np.ndarray:
        return self._data


def Parallel(core: Callable,
             *,
             seed,
             n_jobs: int = -1,
             timeout: float | None = None,
             buffers=(),
             description: str = '',
             text: str = '',
             verbose: int = 0) -> list[Any]:
    """Runs ``core(seed_i, idx=i, status=..., stop=..., <buffers>)`` per seed.

    Args:
        core: Callable invoked once per seed with keyword arguments
            ``idx`` (run index), ``status`` (float buffer the run updates),
            ``stop`` (bool buffer; set by the driver on timeout — runs must
            poll it and exit early), plus one named buffer per entry of
            ``buffers``.
        seed: List of per-run seeds.
        n_jobs: Worker threads (<=0: ``cpu_count + n_jobs + 1``; 0 raises).
        timeout: Seconds before every run's ``stop`` flag is raised
            (reference parallel.py:243-248).
        buffers: ``[(name, fmt), ...]`` extra shared metric buffers.
        verbose: Print a one-line progress summary per second.

    Returns:
        One result per seed, in seed order.
    """
    seeds = list(seed)
    n_runs = len(seeds)
    if n_jobs == 0:
        raise ValueError("'n_jobs' cannot be zero.")
    if n_jobs < 0:
        n_jobs = max(1, (os.cpu_count() or 1) + n_jobs + 1)
    n_jobs = min(n_jobs, max(1, n_runs))

    status = Buffer(n_runs, 'f')
    stop = Buffer(n_runs, '?')
    completed = Buffer(n_runs, '?')
    extra = {name: Buffer(n_runs, fmt) for name, fmt in buffers}

    timer = None
    if timeout is not None:

        def _expire():
            stop.data[:] = True

        timer = threading.Timer(timeout, _expire)
        timer.daemon = True
        timer.start()

    progress_stop = threading.Event()

    def _progress_plain():
        import sys
        while not progress_stop.wait(1.0):
            done = int(completed.data.sum())
            mean_status = float(status.data.mean())
            print(f'\r# runs {done}/{n_runs} status {mean_status:5.1%}',
                  end='', file=sys.stderr, flush=True)
        print(file=sys.stderr)

    def _progress_rich():
        """Per-run live bars with metric fields (reference
        parallel.py:250-317 rendered the same buffers with rich)."""
        from rich.console import Console
        from rich.progress import (Progress, TextColumn,
                                   TimeElapsedColumn)

        names = [name for name, _ in buffers]
        columns = [TextColumn('[blue][{task.fields[idx]}/%d]' % n_runs),
                   *Progress.get_default_columns(), TimeElapsedColumn()]
        if text:
            columns.append(TextColumn(text))
        with Progress(*columns, console=Console(stderr=True),
                      auto_refresh=False) as bars:
            tasks = {}

            def refresh():
                for i in range(n_runs):
                    st = float(status[i])
                    if st <= 0 and not completed[i] and i not in tasks:
                        continue
                    fields = {nm: float(extra[nm][i]) for nm in names}
                    if i not in tasks:
                        tasks[i] = bars.add_task(
                            description or 'Processing...', total=1.0,
                            idx=i + 1, **fields)
                    bars.update(tasks[i],
                                completed=1.0 if completed[i] else st,
                                idx=i + 1, **fields)
                bars.refresh()

            while not progress_stop.wait(0.25):
                refresh()
            refresh()

    def _progress():
        try:
            _progress_rich()
        except Exception:
            _progress_plain()

    reporter = None
    if verbose > 0:
        reporter = threading.Thread(target=_progress, daemon=True)
        reporter.start()

    def run_one(i):
        try:
            return core(seeds[i], idx=i, status=status, stop=stop,
                        **extra)
        finally:
            completed[i] = True

    try:
        with ThreadPoolExecutor(max_workers=n_jobs) as pool:
            results = list(pool.map(run_one, range(n_runs)))
    finally:
        if timer is not None:
            timer.cancel()
        if reporter is not None:
            progress_stop.set()
            reporter.join(timeout=2)

    return results

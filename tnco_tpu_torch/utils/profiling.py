"""Profiling and live-metrics helpers (the port of
``tnco_tpu/utils/profiling.py``).

The reference's observability is progress bars and ``runtime_s``.  Here:
a ``torch.profiler`` trace around annealing chunks (a Chrome trace the
card's kernels appear in) and a moves/sec counter fed by the engines'
move metrics.
"""

from contextlib import contextmanager
import os
import time

__all__ = ['trace', 'ThroughputCounter']


@contextmanager
def trace(log_dir: str | None):
    """``torch.profiler`` trace context (no-op when ``log_dir`` is None).

    Records the host and, where CUDA is available, the card, and writes
    ``trace.json`` (Chrome trace format; open it in Perfetto or
    ``chrome://tracing``) into ``log_dir`` on exit.
    """
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(str(log_dir), 'trace.json'))


class ThroughputCounter:
    """Accumulates SA move counts and reports moves/sec."""

    def __init__(self) -> None:
        self.moves = 0
        self.sweeps = 0
        self._start = time.perf_counter()

    def add(self, moves: int, sweeps: int = 0) -> None:
        self.moves += int(moves)
        self.sweeps += int(sweeps)

    @property
    def elapsed_s(self) -> float:
        return time.perf_counter() - self._start

    @property
    def moves_per_sec(self) -> float:
        dt = self.elapsed_s
        return self.moves / dt if dt > 0 else 0.0

    def report(self) -> dict:
        return {
            'moves': self.moves,
            'sweeps': self.sweeps,
            'runtime_s': self.elapsed_s,
            'moves_per_sec': self.moves_per_sec,
        }

"""Profiling and live-metrics helpers (the port of
``tnco_tpu/utils/profiling.py``).

The reference's observability is progress bars and ``runtime_s``.  Here:

- :func:`trace`: a ``torch.profiler`` Chrome trace around any code, with
  the card's kernels and the program's stage spans on one timeline;
- :func:`span`: a stage span, ``tnco.<layer>.<stage>`` (the runner's
  chunks, the stages of the walker and of the 'walks' engines).  While a
  torch profiler records it is a ``record_function`` event, whose clock
  is the device trace's, and :func:`spans` sums its host seconds; at any
  other time it is one shared null context;
- the counters, one registry of named integers: :func:`count`,
  :func:`counts`, :func:`reset_counts`.  The kernel wrappers count their
  launches there (``launches.<kernel>``, read by
  :func:`tnco_tpu_torch.kernels.launch_counts`), and :func:`host_read`
  counts ``host_reads``, the blocking device-to-host reads of the
  runners' chunk loop, the walker and 'walks' engines and the slicers.
  A counter is read only when asked: counting adds no sync;
- :class:`ThroughputCounter`: the reference's moves/sec counter, which
  callers feed themselves (no engine feeds it).
"""

from contextlib import contextmanager, nullcontext
import os
import time

import torch

__all__ = ['trace', 'span', 'spans', 'count', 'counts', 'reset_counts',
           'host_read', 'ThroughputCounter']

_COUNTS = {}            # counter name -> int
_SPANS = {}             # span name -> [calls, host seconds]
_NULL = nullcontext()


@contextmanager
def trace(log_dir: str | None):
    """``torch.profiler`` trace context (no-op when ``log_dir`` is None).

    Records the host and, where CUDA is available, the card, and writes
    ``trace.json`` (Chrome trace format; open it in Perfetto or
    ``chrome://tracing``) into ``log_dir`` on exit.  The program's stage
    spans (:func:`span`) appear in it beside the kernels they launch.
    """
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(str(log_dir), 'trace.json'))


class _Span:
    """``record_function(name, args)`` that adds its host seconds and one
    call to :func:`spans`' table on exit."""

    __slots__ = ('_name', '_rf', '_t0')

    def __init__(self, name: str, args: str | None) -> None:
        self._name = name
        self._rf = torch.profiler.record_function(name, args)

    def __enter__(self):
        self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._rf.__exit__(*exc)
        entry = _SPANS.setdefault(self._name, [0, 0.0])
        entry[0] += 1
        entry[1] += dt
        return False


def span(name: str, args=None):
    """The stage span ``name`` (``args``, shown beside it in the trace,
    e.g. a chunk's index): a ``record_function`` while a torch profiler
    records, else one shared null context (about 0.4 us a call).  Open
    none inside a per-walk or per-node loop."""
    if not torch.autograd._profiler_enabled():
        return _NULL
    return _Span(name, None if args is None else str(args))


def spans() -> dict:
    """``{name: (calls, host seconds)}`` of the spans closed while a
    profiler recorded, since the last :func:`reset_counts`.  A span's
    seconds include those of the spans inside it, and a span around a
    blocking read holds the queued device work the read waits for."""
    return {k: (c, s) for k, (c, s) in _SPANS.items()}


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to counter ``name``."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def counts() -> dict:
    """A copy of every counter."""
    return dict(_COUNTS)


def reset_counts(names=None) -> None:
    """Sets the counters ``names`` to 0; with None, clears every counter
    and the span table."""
    if names is None:
        _COUNTS.clear()
        _SPANS.clear()
        return
    for name in names:
        _COUNTS[name] = 0


def host_read(x, cast):
    """``cast(x)`` (``int``, ``bool`` or ``float``) of a tensor, counted
    as one ``host_reads``: on the card, the host waits here for every
    queued operation."""
    count('host_reads')
    return cast(x)


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

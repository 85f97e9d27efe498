"""Reads a ``torch.profiler`` trace of the traced chunks.

The harness wraps the traced chunks in one ``torch.profiler.profile``
(host and CUDA activity) and one ``record_function`` span,
:data:`SPAN`.  This module takes the raw events out of the profiler
without building its per-event Python objects (an FW chunk launches some
hundreds of thousands of kernels), and sums them:

- every device operation (kernels, copies, sets; not the profiler's
  device-side copies of host spans) with its start and end;
- ``launches``: the device kernels among them;
- ``device_s``: their summed durations; ``busy_s``: the length of the
  union of their intervals inside the span; ``window_s``: the span's
  length;
- ``device_ops``: the ten names with the most device time;
- ``idle_gaps``: the device's idle time inside the span, each gap charged
  to the innermost host event running at its midpoint, the ten names with
  the most.
"""

__all__ = ['SPAN', 'Trace', 'read']

SPAN = 'portbench.traced_chunks'
_NAME_CHARS = 80


def _ns(ev, what):
    """An event's ``start`` or ``duration`` in ns (newer PyTorch gives
    ns, older gives us)."""
    fn = getattr(ev, f'{what}_ns', None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, f'{what}_us')() * 1000)


def _is_annotation(ev) -> bool:
    fn = getattr(ev, 'is_user_annotation', None)
    if fn is not None and fn():
        return True
    fn = getattr(ev, 'activity_type', None)
    return fn is not None and 'annotation' in str(fn())


class Trace:
    """The sums of one traced region (see the module's docstring)."""

    def __init__(self, launches, device_s, busy_s, window_s, device_ops,
                 idle_gaps):
        self.launches = launches
        self.device_s = device_s
        self.busy_s = busy_s
        self.window_s = window_s
        self.device_ops = device_ops
        self.idle_gaps = idle_gaps


def _top(sums: dict, n: int = 10):
    return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])
            [:n]]


def read(prof) -> Trace:
    """Sums the events of ``prof`` (a finished ``torch.profiler.profile``)
    inside its :data:`SPAN`."""
    events = prof.profiler.kineto_results.events()
    dev, host = [], []
    span = None
    for ev in events:
        kind = str(ev.device_type())
        name = ev.name()
        if kind.endswith('CPU'):
            start = _ns(ev, 'start')
            end = start + _ns(ev, 'duration')
            if name == SPAN:
                span = (start, end)
            host.append((start, end, name))
        elif not _is_annotation(ev) and name != SPAN:
            start = _ns(ev, 'start')
            dev.append((start, start + _ns(ev, 'duration'), name))
    if span is None:
        raise RuntimeError(f'The trace holds no {SPAN!r} span.')
    w0, w1 = span
    dev = [(max(s, w0), min(e, w1), n) for s, e, n in dev if e > w0 and
           s < w1]
    launches = sum(1 for _, _, n in dev
                   if not n.startswith(('Memcpy', 'Memset')))
    op_s = {}
    for s, e, n in dev:
        key = n[:_NAME_CHARS]
        op_s[key] = op_s.get(key, 0.0) + (e - s) / 1e9
    device_s = sum(op_s.values())

    # The union of the device intervals, and the gaps between them.
    busy_ns = 0
    gaps = []
    cursor = w0
    for s, e, _ in sorted(dev):
        if s > cursor:
            gaps.append((cursor, s))
        if e > cursor:
            busy_ns += e - max(s, cursor)
            cursor = e
    if cursor < w1:
        gaps.append((cursor, w1))

    # Each gap goes to the innermost host event at its midpoint: a sweep
    # over the host events in start order keeps the nested events that
    # are still running on a stack.
    host = sorted(h for h in host if h[2] != SPAN)
    gap_s = {}
    stack = []
    j = 0
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        while j < len(host) and host[j][0] <= mid:
            while stack and stack[-1][1] < host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2][:_NAME_CHARS] if stack else \
            'host outside any event'
        gap_s[name] = gap_s.get(name, 0.0) + (g1 - g0) / 1e9
    return Trace(launches, device_s, busy_ns / 1e9, (w1 - w0) / 1e9,
                 _top(op_s), _top(gap_s))

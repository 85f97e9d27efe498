"""The program's stage spans and counters, as the benchmark reads them.

The program (``tnco_tpu_torch.utils.profiling``) opens a
``record_function`` span, ``tnco.<layer>.<stage>``, around each stage of
a chunk while a torch profiler records, sums the spans' host seconds
(``spans()``), and counts in one registry (``counts()``): the kernels'
launches and ``host_reads``, its blocking device-to-host reads.  This
module imports nothing of the program: :func:`program_spans` and
:func:`program_counts` read the registry of the program the run has
loaded, and give None where it has none (an older program), so that a
metric that reads them falls silent there.

:func:`read` makes one pass over a finished profiler's events, as
:mod:`portbench.trace` does, and gives for each ``tnco.*`` span name:

- ``calls`` and ``host_s``, its summed host seconds (inclusive);
- ``device_s``: the device seconds of the operations launched inside it.
  Each device operation is linked to the runtime call that launched it
  (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...) by its correlation id,
  or else to the PyTorch operator it came from, and charged to the
  innermost ``tnco.*`` span holding that call;
- ``idle_s``: the device's idle seconds in the gaps whose midpoint falls
  inside it (innermost, as for ``device_s``).

Device time and gaps that no span holds go under ``(none)``, device
operations with no launch found under ``(unlinked)``.

A traced run (:func:`portbench.harness.execute` with ``trace``) reads its
profiler with :func:`read` and hands the table to the metric readers as
``ctx.spans``, beside ``ctx.counts``, the program's counters over the
traced chunks alone; its result line carries both, under ``spans`` and
``counts``.  ``python3 -m portbench.spans --workload <name> --seed <n>
--seconds <s>`` is ``python3 -m portbench.run`` with ``--trace 1``.
"""

import re
import sys

from portbench import trace as ptrace

__all__ = ['PROGRAM', 'program_spans', 'program_counts', 'window_pct',
           'read', 'execute', 'main']

PROGRAM = 'tnco_tpu_torch.utils.profiling'
NONE, UNLINKED = '(none)', '(unlinked)'
_PREFIX = 'tnco.'
# The host's CUDA API calls (cudaLaunchKernel, cuLaunchKernel,
# cudaMemcpyAsync, ...): a device operation shares their correlation id.
_RUNTIME = re.compile(r'^cu(da)?[A-Z]')


def _registry():
    mod = sys.modules.get(PROGRAM)
    if mod is None or not hasattr(mod, 'spans') or \
            not hasattr(mod, 'counts'):
        return None
    return mod


def program_spans():
    """``{name: (calls, host seconds)}`` of the program's spans while a
    profiler recorded, or None."""
    mod = _registry()
    return None if mod is None else mod.spans()


def program_counts():
    """The program's counters, or None."""
    mod = _registry()
    return None if mod is None else mod.counts()


def window_pct(ctx, name: str):
    """The host seconds of the program's ``name`` spans in the traced
    chunks as a share of the traced window, in %, or None."""
    table = program_spans()
    if ctx.trace is None or not table or name not in table:
        return None
    return 100.0 * table[name][1] / ctx.trace.window_s


def _innermost(spans, times):
    """For each of ``times`` (ascending), the name of the innermost of
    ``spans`` (``(start, end, name)``, nested, sorted by start and then
    longest first) that holds it, or None."""
    out = []
    stack = []
    j = 0
    for t in times:
        while j < len(spans) and spans[j][0] <= t:
            while stack and stack[-1][1] < spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def read(prof, window: str = ptrace.SPAN) -> dict:
    """The span table (see the module's docstring) of ``prof``, a
    finished ``torch.profiler.profile``, inside its ``window`` span."""
    spans, device = [], []
    launch_at, op_at = {}, {}
    win = None
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start = ptrace._ns(ev, 'start')
        if str(ev.device_type()).endswith('CPU'):
            end = start + ptrace._ns(ev, 'duration')
            if name == window:
                win = (start, end)
            elif name.startswith(_PREFIX):
                spans.append((start, end, name))
            if _RUNTIME.match(name):
                launch_at[ev.correlation_id()] = start
            else:
                op_at[ev.correlation_id()] = start
        elif not ptrace._is_annotation(ev) and name != window:
            device.append((start, start + ptrace._ns(ev, 'duration'),
                           ev.correlation_id(), ev.linked_correlation_id()))
    if win is None:
        raise RuntimeError(f'The trace holds no {window!r} span.')
    w0, w1 = win
    spans = sorted((s for s in spans if s[1] > w0 and s[0] < w1),
                   key=lambda s: (s[0], -s[1]))
    table = {}

    def entry(name):
        return table.setdefault(name, {'calls': 0, 'host_s': 0.0,
                                       'device_s': 0.0, 'idle_s': 0.0})

    for s, e, name in spans:
        ent = entry(name)
        ent['calls'] += 1
        ent['host_s'] += (e - s) / 1e9

    device = [(max(s, w0), min(e, w1), c, lc) for s, e, c, lc in device
              if e > w0 and s < w1]
    linked, unlinked = [], 0.0
    for s, e, corr, link in device:
        at = launch_at.get(corr, op_at.get(link))
        if at is None:
            unlinked += (e - s) / 1e9
        else:
            linked.append((at, (e - s) / 1e9))
    linked.sort()
    for (_, sec), name in zip(linked, _innermost(spans,
                                                 [a for a, _ in linked])):
        entry(name or NONE)['device_s'] += sec
    if unlinked:
        entry(UNLINKED)['device_s'] += unlinked

    gaps = []
    cursor = w0
    for s, e, _, _ in sorted(device):
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if cursor < w1:
        gaps.append((cursor, w1))
    for (g0, g1), name in zip(gaps, _innermost(
            spans, [(g0 + g1) // 2 for g0, g1 in gaps])):
        entry(name or NONE)['idle_s'] += (g1 - g0) / 1e9
    return table


def execute(workload: str, seed: int, seconds: float, **kw):
    """A traced run of ``workload`` (:func:`portbench.harness.execute`
    with ``trace``; ``kw`` passed on).  Returns ``(result, span
    table)``."""
    from portbench import harness
    out = harness.execute(workload, seed, seconds, True, **kw)
    return out, out['spans']


def main(argv=None) -> int:
    from portbench import run
    return run.main(list(sys.argv[1:] if argv is None else argv) +
                    ['--trace', '1'])


if __name__ == '__main__':
    sys.exit(main())

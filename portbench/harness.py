"""One run of one cell: set-up, the measured window, the traced chunks,
the check, and the result line.

:func:`execute` does the work and returns the result as a dict; the
command line (:mod:`portbench.run`) adds the look for a card and prints.
The order of a run:

1. the cell's network (:mod:`portbench.networks`), its distinct
   starting paths (loaded from the mix's starts file,
   :mod:`portbench.paths`, the same for every seed; built on the host
   where the mix names none), the replicas' seeds from the seed, and the
   runner built on the paths and widened to the cell's replicas
   (:mod:`portbench.runners`);
2. one warm-up chunk, the first of the anneal; set-up ends here;
3. the window: chunks back to back, each a ``run`` call that ends in a
   synchronize, until ``seconds`` have passed;
4. with ``trace``, a few more chunks under the profiler, read by
   :mod:`portbench.trace` (device time and gaps) and
   :mod:`portbench.spans` (the program's stage spans), with the counts
   the rooflines need and the program's counters over these chunks alone;
5. the peak device memory, the program's answers for a sample of the
   replicas drawn from the seed and the best one, the program's state
   freed, and the reference's judgement (:mod:`portbench.check`).

The anneal follows the app's form: one beta per iteration, rising
linearly from 0 to ``beta_max`` over ``anneal_iterations`` iterations,
then held, so a faster program runs the same anneal and then anneals
longer at ``beta_max``.
"""

import gc
import subprocess
import sys
import time

import numpy as np

from portbench import (check, networks, paths, reference, runners, spans,
                       spec)
from portbench import trace as ptrace

__all__ = ['execute', 'Context', 'FORBIDDEN', 'forbidden_modules']

# Modules that no run may load: JAX and the JAX package (top-level names
# compared whole; the port's own name begins with the JAX package's).
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'tnco_tpu')


def forbidden_modules() -> list:
    """The forbidden top-level modules in ``sys.modules``."""
    top = {name.split('.')[0] for name in sys.modules}
    return sorted(top.intersection(FORBIDDEN))


class Context:
    """What a metric's reader reads: ``config``, ``traffic``, ``sizes``
    (``b, n, w, p, k``), ``setup_s``, ``chunk_s`` (each window chunk's
    host seconds), ``window_s``, ``proposals`` (in the window, by
    :func:`portbench.runners.proposals`), ``best_log2`` (the
    reference's exact log2 cost of the best tree), ``trace`` (a
    :class:`portbench.trace.Trace`, or None), ``traced`` (counts of the
    traced chunks: ``chunks``, ``iterations``, ``improved``, ``applied``,
    ``reslices``), ``spans`` (:func:`portbench.spans.read` of the traced
    chunks, or None), ``counts`` (the program's counters over the traced
    chunks alone, or None) and ``device_name``."""

    def __init__(self, **kw):
        self.trace = None
        self.traced = None
        self.spans = None
        self.counts = None
        self.__dict__.update(kw)


def _seeds(seed: int, b: int, n_sample: int):
    """The replicas' seeds and the judged sample, from ``seed``."""
    ss = np.random.SeedSequence([int(seed), 0x5eed])
    replica_seeds = [int(x) for x in ss.generate_state(b, dtype=np.uint32)]
    rng = np.random.Generator(np.random.PCG64(ss.spawn(1)[0]))
    sample = sorted(int(x) for x in rng.choice(b, min(n_sample, b),
                                               replace=False))
    return replica_seeds, sample


def _betas(traffic, i0: int, k: int) -> np.ndarray:
    i = np.arange(i0, i0 + k, dtype=np.float64)
    frac = np.minimum(i / traffic['anneal_iterations'], 1.0)
    return (traffic['beta_max'] * frac).astype(np.float32)


def _reslices(traffic, k: int) -> int:
    """Reslice steps in one chunk (a ``run`` call reslices at its steps
    ``0, u, 2u, ...``)."""
    u = traffic.get('update_slices', 0)
    return -(-k // u) if u else 0


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return 'not read'
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        'not read'


def execute(workload: str, seed: int, seconds: float, trace: bool, *,
            t0: float | None = None, device=None, overrides=None,
            control: bool = False) -> dict:
    """Runs ``workload`` and returns its result line as a dict.

    ``t0``: the host clock at the process's start (set-up is counted from
    it); ``device``: None for the card, ``'cpu'`` to drive the rest of a
    run without one (tests); ``overrides``: ``{'config': {...},
    'traffic': {...}}`` entries laid over the cell's files (tests);
    ``control``: also judge the lower-precision control, under
    ``'control'`` (its own ``correct`` and ``checks``)."""
    t0 = time.perf_counter() if t0 is None else t0
    import torch

    cell = spec.cell(spec.load(), workload)
    config, traffic = dict(cell['config']), dict(cell['traffic'])
    for key, part in (('config', config), ('traffic', traffic)):
        part.update((overrides or {}).get(key, {}))
    dev = torch.device(device or 'cuda')
    cuda = dev.type == 'cuda'
    fw = config['runner'] == 'ReplicaRunnerFW'
    b, k = traffic['replicas'], config['chunk_size']
    n_trees = min(traffic['distinct_trees'], b)

    ts_inds, output_inds, dims = networks.build(config['network'])
    order = networks.index_order(ts_inds)
    replica_seeds, sample = _seeds(seed, b, traffic['check_sample'])
    # Every seed starts from the same paths (those of seeds 0, 1, ...),
    # kept in the mix's starts file: the seed moves the anneal's draws,
    # not its starting point.
    if traffic.get('starts'):
        starts = paths.load_starts(spec.starts_file(traffic['starts']),
                                   config['network'], n_trees)
    else:
        starts = [paths.random_path(ts_inds, output_inds, dims, s)
                  for s in range(n_trees)]
    phases = {'paths_s': time.perf_counter() - t0}
    runner = runners.build(config, ts_inds, output_inds, dims, order,
                           starts, replica_seeds[:n_trees], dev)
    phases['runner_s'] = time.perf_counter() - t0
    runners.widen(runner, replica_seeds)
    phases['widen_s'] = time.perf_counter() - t0
    p = runner.n_walks
    n, w = runner.template.inds_array.shape

    def sync():
        if cuda:
            torch.cuda.synchronize()

    chunk = 0

    def one_chunk():
        nonlocal chunk
        runners.run_chunk(runner, config, traffic,
                          _betas(traffic, chunk * k, k))
        sync()
        chunk += 1

    one_chunk()                                           # warm-up
    setup_s = time.perf_counter() - t0

    chunk_s = []
    walked0 = runners.count_walked(runner)
    w0 = time.perf_counter()
    while True:
        c0 = time.perf_counter()
        one_chunk()
        c1 = time.perf_counter()
        chunk_s.append(c1 - c0)
        if c1 - w0 >= seconds:
            break
    window_s = c1 - w0
    walked = runners.count_walked(runner) - walked0
    phases['window_chunks'] = len(chunk_s)

    ctx = Context(config=config, traffic=traffic, sizes=(b, n, w, p, k),
                  setup_s=setup_s, chunk_s=chunk_s, window_s=window_s,
                  proposals=runners.proposals(runner, len(chunk_s), k,
                                              len(ts_inds), walked),
                  device_name=(torch.cuda.get_device_name(dev) if cuda
                               else 'cpu'))
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        improved = applied = 0
        counts0 = spans.program_counts()
        with profile(activities=acts) as prof:
            with record_function(ptrace.SPAN):
                for _ in range(traffic['trace_chunks']):
                    before = runner.log2_min_totals()
                    a0 = runners.count_applied(runner)
                    one_chunk()
                    improved += int((runner.log2_min_totals() <
                                     before).sum())
                    applied += runners.count_applied(runner) - a0
        counts1 = spans.program_counts()
        if counts1 is not None:
            ctx.counts = {name: n - counts0.get(name, 0)
                          for name, n in counts1.items()}
        t_read = time.perf_counter()
        ctx.trace = ptrace.read(prof)
        ctx.spans = spans.read(prof)
        del prof
        phases['trace_read_s'] = time.perf_counter() - t_read
        ctx.traced = dict(
            chunks=traffic['trace_chunks'],
            iterations=traffic['trace_chunks'] * k, improved=improved,
            applied=applied,
            reslices=traffic['trace_chunks'] * _reslices(traffic, k))

    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    best = int(np.argmin(runner.log2_min_totals()))
    judged = sorted(set(sample) | {best})
    ans = runners.answers(runner, judged, fw)
    engine = runner.engine
    del runner
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    ref = reference.Reference(ts_inds, output_inds, dims, order)
    judge_args = (ref, ans, [starts[r % n_trees] for r in range(b)], best,
                  config['check'], config['max_width'] if fw else None)
    verdict = check.judge(*judge_args)
    ctx.best_log2 = verdict.best_log2
    phases['check_s'] = time.perf_counter() - t_check

    metrics = {}
    for m in cell['per_layer'] if trace else cell['end_to_end']:
        value = spec.reader(m['name'])(ctx)
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    device_info = {'platform': 'gpu' if cuda else 'cpu',
                   'kind': ctx.device_name, 'count': 1,
                   'memory_peak_bytes': int(memory_peak)}
    out = {'correct': verdict.correct, 'attempted': verdict.attempted,
           'failed': verdict.failed, 'metrics': metrics,
           'device': device_info}
    if trace:
        device_info['busy_s'] = ctx.trace.busy_s
        device_info['window_s'] = ctx.trace.window_s
        device_info['power_limit'] = _power_limit() if cuda else 'cpu'
        out['breakdown'] = {'device_ops': ctx.trace.device_ops,
                            'idle_gaps': ctx.trace.idle_gaps}
    out['engine'] = engine
    out['phases'] = phases
    out['proposals'] = ctx.proposals
    out['reasons'] = verdict.reasons
    if control:
        low = check.judge(*judge_args, control=True)
        out['control'] = {'correct': low.correct, 'checks': _numbers(low)}
    if trace:
        out['spans'] = ctx.spans
        out['counts'] = ctx.counts
    out['checks'] = _numbers(verdict)
    return out


def _numbers(verdict) -> dict:
    return {name: {'value': v, 'limit': lim}
            for name, (v, lim) in verdict.numbers.items()}

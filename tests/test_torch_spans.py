"""The program's stage spans and counters (``utils/profiling.py``), and
the benchmark's readers of them (``portbench/spans.py`` and the metrics
``claim_pct.fw``, ``reslice_pct.fw``, ``host_reads_per_chunk.fw``).

The CPU cases run the Sycamore-53 network at 4 cycles on the engines
'auto' picks for the benchmark's cells on the card ('walks' under a width
cap, the walker without one), at 16 replicas and chunks of 32, under
``torch.profiler``; the card cases (``cuda``) check the walker's spans
and the link from each device operation to the span that launched it.
"""

import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from portbench import harness, networks, paths, runners, spec
from portbench import spans as pspans
from tnco_tpu_torch.benchmarks import gather_probe as gp
from tnco_tpu_torch.kernels import gather as kg
from tnco_tpu_torch.kernels import launch_counts, reset_launch_counts
from tnco_tpu_torch.kernels import scatter as ks
from tnco_tpu_torch.utils import profiling

FW, IM = 'syc53_fw30_walks_b2048', 'syc53_im_walker_b1024'
SEED = 2**31 + 11
K = 32                  # iterations a chunk
RESLICES = 4            # a chunk of 32 reslices at its steps 0, 10, 20, 30
STAGES = ('draws', 'propose', 'claim', 'apply', 'snapshot')
NEW_METRICS = ('claim_pct.fw', 'reslice_pct.fw', 'host_reads_per_chunk.fw')


def tiny(workload: str, engine=None) -> dict:
    """The cell at a CPU size: 4 cycles, 16 replicas from 4 paths, chunks
    of 32; FW under 2^8, where the slicer has slices to find."""
    config = {'network': {'generator': 'sycamore53', 'm_cycles': 4},
              'engine': engine or ('walks' if workload == FW else 'walker'),
              'chunk_size': K}
    if workload == FW:
        config['max_width'] = 8
    return {'config': config,
            'traffic': {'replicas': 16, 'distinct_trees': 4, 'starts': None,
                        'anneal_iterations': 32, 'check_sample': 8,
                        'trace_chunks': 1}}


def tiny_runner(workload: str, engine=None, device='cpu'):
    """``(runner, config, traffic)`` of :func:`tiny`, built and widened
    as the harness builds them."""
    cell = spec.cell(spec.load(), workload)
    over = tiny(workload, engine)
    config = {**cell['config'], **over['config']}
    traffic = {**cell['traffic'], **over['traffic']}
    ts_inds, out, dims = networks.build(config['network'])
    starts = [paths.random_path(ts_inds, out, dims, s) for s in range(4)]
    runner = runners.build(config, ts_inds, out, dims,
                           networks.index_order(ts_inds), starts,
                           [1, 2, 3, 4], torch.device(device))
    runners.widen(runner, list(range(100, 100 + traffic['replicas'])))
    return runner, config, traffic


def traced_chunk(runner, config, traffic, cuda=False):
    """One chunk under the profiler inside the window span; returns the
    profiler."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    betas = np.linspace(1, 8, config['chunk_size']).astype(np.float32)
    with profile(activities=acts) as prof:
        with record_function(pspans.ptrace.SPAN):
            runners.run_chunk(runner, config, traffic, betas)
            if cuda:
                torch.cuda.synchronize()
    return prof


def _intervals(prof, prefix='tnco.'):
    out = []
    for ev in prof.profiler.kineto_results.events():
        if str(ev.device_type()).endswith('CPU') and \
                ev.name().startswith(prefix):
            s = pspans.ptrace._ns(ev, 'start')
            out.append((s, s + pspans.ptrace._ns(ev, 'duration'), ev.name()))
    return out


@pytest.fixture(scope='module')
def fw_run():
    """A whole traced FW run through the harness, with the program's
    counters and the span table of its profiler."""
    profiling.reset_counts()
    out, table = pspans.execute(FW, SEED, 0.2, device='cpu',
                                overrides=tiny(FW))
    return out, table, profiling.counts()


@pytest.fixture
def no_counts():
    profiling.reset_counts()
    yield
    profiling.reset_counts()


# ---------------------------------------------------------------- span ---


def test_span_without_a_profiler_is_one_null_context(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError('record_function entered with no profiler')

    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    a, b = profiling.span('tnco.a.b'), profiling.span('tnco.c.d', 3)
    assert a is b
    with a:
        pass
    assert 'tnco.a.b' not in profiling.spans()


def test_span_under_a_profiler_is_an_event_with_its_args(no_counts):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with profiling.span('tnco.test.outer', i):
                with profiling.span('tnco.test.inner'):
                    torch.ones(4).sum()
    names = [n for _, _, n in _intervals(prof)]
    assert names.count('tnco.test.outer') == 3
    assert names.count('tnco.test.inner') == 3
    table = profiling.spans()
    assert table['tnco.test.outer'][0] == table['tnco.test.inner'][0] == 3
    assert table['tnco.test.outer'][1] >= table['tnco.test.inner'][1] > 0
    with profiling.span('tnco.test.outer'):         # no profiler: no sum
        pass
    assert profiling.spans()['tnco.test.outer'][0] == 3


# ------------------------------------------------------------ counters ---


def test_counters_add_copy_and_reset(no_counts):
    profiling.count('a')
    profiling.count('a', 4)
    profiling.count('b', 2)
    got = profiling.counts()
    assert got == {'a': 5, 'b': 2}
    got['a'] = 0
    assert profiling.counts()['a'] == 5
    profiling.reset_counts(['a'])
    assert profiling.counts() == {'a': 0, 'b': 2}
    assert profiling.host_read(torch.tensor(7), int) == 7
    assert profiling.host_read(torch.tensor([0, 1]).any(), bool) is True
    assert profiling.counts()['host_reads'] == 2
    profiling.reset_counts()
    assert profiling.counts() == {} and profiling.spans() == {}


def test_launch_counts_read_the_registry(no_counts):
    keys = {'gather_gbn', 'inv_ids', 'scatter_rows_inplace',
            'scatter_rows_gbn', 'walker_im', 'walker_fw', 'probe_loop',
            'probe_take', 'claim_disjoint'}
    assert launch_counts() == dict.fromkeys(keys, 0)
    profiling.count('launches.walker_im', 3)
    profiling.count('host_reads')
    assert launch_counts()['walker_im'] == 3
    reset_launch_counts()
    assert launch_counts() == dict.fromkeys(keys, 0)
    assert profiling.counts()['host_reads'] == 1


def _plain_gather():
    kg.gather_gbn(torch.zeros((2, 3, 4), dtype=torch.int32),
                  torch.zeros((3, 2), dtype=torch.int32))


def _plain_scatters():
    vals = torch.zeros((2, 3, 4), dtype=torch.int32)
    ids = torch.zeros((3, 2), dtype=torch.int32)
    upd = torch.ones((2, 3, 2), dtype=torch.int32)
    ks.scatter_rows_inplace(vals, ids, upd)
    ks.scatter_rows_gbn(vals, ids, upd)
    ks.inv_ids(ids, 4)


def _plain_probe():
    state = torch.zeros((8, gp.COLS), dtype=torch.int32)
    ids = torch.zeros((2, 4), dtype=torch.int32)
    for impl in gp.IMPLS:
        gp.probe(state, ids, impl)


def _plain_walker():
    runner, config, traffic = tiny_runner(IM)
    runners.run_chunk(runner, config, traffic,
                      np.ones(4, dtype=np.float32))


@pytest.mark.parametrize('route', [_plain_gather, _plain_scatters,
                                   _plain_probe, _plain_walker],
                         ids=lambda f: f.__name__[1:])
def test_plain_routes_count_no_launch(route, no_counts):
    route()
    assert set(launch_counts().values()) == {0}


# --------------------------------------------------------- the engines ---


def test_fw_stage_spans_once_an_iteration_under_the_chunk(no_counts):
    runner, config, traffic = tiny_runner(FW)
    prof = traced_chunk(runner, config, traffic)
    got = _intervals(prof)
    names = [n for _, _, n in got]
    for stage in STAGES:
        assert names.count(f'tnco.walks.{stage}') == K, stage
    assert names.count('tnco.walks.reslice') == RESLICES
    for one in ('tnco.walks.pack', 'tnco.walks.unpack', 'tnco.runner.chunk',
                'tnco.runner.count'):
        assert names.count(one) == 1, one
    (c0, c1, _), = [s for s in got if s[2] == 'tnco.runner.chunk']
    assert all(c0 <= s and e <= c1 for s, e, _ in got)


def test_im_walks_engine_has_the_stage_spans(no_counts):
    runner, config, traffic = tiny_runner(IM, engine='walks')
    prof = traced_chunk(runner, config, traffic)
    names = [n for _, _, n in _intervals(prof)]
    for stage in ('propose', 'claim', 'apply'):
        assert names.count(f'tnco.walks.{stage}') == K, stage
    assert 'tnco.walks.reslice' not in names


@pytest.mark.parametrize('workload, per_chunk', [
    (FW, 2 * RESLICES + 1),     # each reslice's any(), the slicer's entry,
    (IM, 1)])                   # and the applied count
def test_host_reads_are_exact(workload, per_chunk, no_counts):
    runner, config, traffic = tiny_runner(workload)
    assert profiling.counts().get('host_reads', 0) == 0     # set-up
    betas = np.ones(K, dtype=np.float32)
    for chunk in range(1, 3):
        runners.run_chunk(runner, config, traffic, betas)
        assert profiling.counts()['host_reads'] == chunk * per_chunk


# ------------------------------------------------- the benchmark's side ---


def test_span_table_of_a_cpu_trace(fw_run):
    out, table, _ = fw_run
    assert out['correct'], out['checks']
    for stage in STAGES:
        assert table[f'tnco.walks.{stage}']['calls'] == K
    assert table['tnco.walks.reslice']['calls'] == RESLICES
    assert table['tnco.runner.chunk']['calls'] == 1
    inside = sum(v['host_s'] for k, v in table.items()
                 if k.startswith('tnco.walks.') or k == 'tnco.runner.count')
    assert 0 < inside <= table['tnco.runner.chunk']['host_s']
    assert all(v['host_s'] > 0 for k, v in table.items()
               if k.startswith('tnco.'))
    assert sum(v['device_s'] for v in table.values()) == 0      # the CPU


def test_traced_run_reports_the_new_metrics(fw_run):
    out, _, counts = fw_run
    m = out['metrics']
    assert 0 < m['claim_pct.fw']['value'] < 100
    assert 0 < m['reslice_pct.fw']['value'] < 100
    assert m['host_reads_per_chunk.fw']['value'] == 2 * RESLICES + 1
    chunks = 1 + out['phases']['window_chunks'] + 1
    assert counts['host_reads'] == chunks * (2 * RESLICES + 1)


@pytest.mark.parametrize('name', NEW_METRICS)
def test_readers_find_nothing_without_a_trace(name):
    ctx = harness.Context(device_name='cpu', chunk_s=[0.1], window_s=0.1)
    assert spec.reader(name)(ctx) is None


@pytest.mark.parametrize('name', NEW_METRICS)
def test_readers_fall_silent_on_a_program_without_the_registry(
        name, monkeypatch):
    monkeypatch.setitem(__import__('sys').modules, pspans.PROGRAM,
                        types.ModuleType(pspans.PROGRAM))
    trace = types.SimpleNamespace(window_s=1.0, busy_s=0.5, device_s=0.5)
    ctx = harness.Context(device_name='cpu', chunk_s=[0.1], window_s=0.1,
                          trace=trace, traced={'chunks': 1})
    assert spec.reader(name)(ctx) is None


# ------------------------------------------------------------- the card ---


def _card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the CUDA kernels have no CPU '
                    'mode); run python -m pytest -m cuda '
                    'tests/test_torch_spans.py on the card')


@pytest.mark.cuda
def test_walker_spans_on_the_card(no_counts):
    _card()
    runner, config, traffic = tiny_runner(IM, device='cuda')
    runners.run_chunk(runner, config, traffic, np.ones(K, np.float32))
    prof = traced_chunk(runner, config, traffic, cuda=True)
    names = [n for _, _, n in _intervals(prof)]
    for stage in ('draws', 'pack', 'k5', 'unpack', 'finish'):
        assert names.count(f'tnco.walker.{stage}') == 1, stage
    table = pspans.read(prof)
    assert table['tnco.walker.k5']['device_s'] > 0
    assert launch_counts()['walker_im'] == 2


@pytest.mark.cuda
@pytest.mark.parametrize('workload', [IM, FW])
def test_device_time_is_charged_to_the_spans(workload, no_counts):
    _card()
    runner, config, traffic = tiny_runner(workload, device='cuda')
    runners.run_chunk(runner, config, traffic, np.ones(K, np.float32))
    prof = traced_chunk(runner, config, traffic, cuda=True)
    table = pspans.read(prof)
    total = pspans.ptrace.read(prof).device_s
    charged = sum(v['device_s'] for k, v in table.items()
                  if k.startswith('tnco.'))
    assert total > 0 and charged >= 0.95 * total, table
    kernels = ('walker_im',) if workload == IM else (
        'gather_gbn', 'scatter_rows_inplace')
    assert all(launch_counts()[k] > 0 for k in kernels)

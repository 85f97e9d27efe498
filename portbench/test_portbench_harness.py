"""The harness's extension points (CPU): networks frozen into data files,
proposals counted by the engine that ran, run options from the traffic
mix, and whole runs of the lockstep engine 'batched' on a frozen,
fused network with open indices."""

import json
import types

import numpy as np
import pytest
import torch

from portbench import harness, networks, paths, runners, spec
from tnco_tpu_torch.kernels import sa_batched
from tnco_tpu_torch.parallel import replicas

IM, FW = 'syc53_im_walker_b1024', 'syc53_fw30_walks_b2048'
SEED = 2**31 + 23
K = 8                   # iterations a chunk
B = 16                  # replicas
THIS = 'portbench.test_portbench_harness'


def open_sycamore53(m_cycles: int, n_open: int):
    """Sycamore-53 of ``m_cycles`` cycles with the final states of its
    first ``n_open`` qubits left off: their last legs are open."""
    ts_inds, _, dims = networks.sycamore53_tn(m_cycles)
    first = len(ts_inds) - len(networks.sycamore53_qubits())
    opened = frozenset(x for xs in ts_inds[first:first + n_open] for x in xs)
    return ts_inds[:first] + ts_inds[first + n_open:], opened, dims


def labelled_chain():
    """A chain of three tensors on integer indices, in order of first
    appearance, with both ends open."""
    return [(0, 1), (1, 2), (2, 3)], frozenset({0, 3}), {0: 2, 1: 3, 2: 4,
                                                         3: 5}


@pytest.fixture
def nets(tmp_path, monkeypatch):
    """``nets/`` in a temporary directory."""
    monkeypatch.setattr(spec, 'net_file', lambda name: tmp_path /
                        f'{name}.json')
    return tmp_path


@pytest.fixture
def fused(nets):
    """``nets/fused.json``: Sycamore-53 at 4 cycles with 6 open qubits,
    fused by the program at width 4, written by the writer (the open
    network first frozen in a file of its own)."""
    networks.freeze('open', f'{THIS}:open_sycamore53',
                    {'m_cycles': 4, 'n_open': 6}, 'a test network')
    networks.freeze('fused', 'portbench.runners:fused_network',
                    {'network': {'file': 'open'}, 'max_width': 4,
                     'seed': 1}, 'a test network')
    return {'file': 'fused'}


def tiny(network, engine='batched', fw=False, **traffic) -> dict:
    config = {'network': network, 'engine': engine, 'chunk_size': K}
    if fw:
        config['max_width'] = 8
    return {'config': config,
            'traffic': {'replicas': B, 'distinct_trees': 4, 'starts': None,
                        'anneal_iterations': 2 * K, 'check_sample': 8,
                        'trace_chunks': 1, **traffic}}


# ------------------------------------------------------------ networks ---


def test_the_generator_entry_is_unchanged():
    for name in ('syc53_m20_im', 'syc53_m20_fw30'):
        network = json.loads((spec.HERE / 'configs' / f'{name}.json')
                             .read_text())['network']
        got = networks.build(network)
        want = networks.sycamore53_tn(20)
        assert got == want
        assert networks.index_order(got[0]) == networks.index_order(want[0])
        starts = paths.load_starts(spec.starts_file('syc53_m20_x16'),
                                   network, 16)
        assert len(starts) == 16


def test_a_file_network_round_trips(nets):
    networks.freeze('chain', f'{THIS}:labelled_chain', {}, 'a chain')
    assert networks.build({'file': 'chain'}) == labelled_chain()
    data = json.loads((nets / 'chain.json').read_text())
    assert data['source'] == 'a chain'
    assert data['built_by'].startswith(
        f'python3 -m portbench.networks write chain {THIS}:labelled_chain')
    with pytest.raises(ValueError):
        networks.build({'file': 'chain', 'm_cycles': 4})


def test_a_network_is_renamed_in_order_of_first_appearance(nets):
    ts_inds, out, dims = open_sycamore53(4, 6)
    networks.freeze('open', f'{THIS}:open_sycamore53',
                    {'m_cycles': 4, 'n_open': 6}, 'test')
    got_ts, got_out, got_dims = networks.build({'file': 'open'})
    ids = {x: i for i, x in enumerate(networks.index_order(ts_inds))}
    assert got_ts == [tuple(ids[x] for x in xs) for xs in ts_inds]
    assert got_out == frozenset(ids[x] for x in out) and len(got_out) == 6
    assert got_dims == {ids[x]: d for x, d in dims.items() if x in ids}
    assert networks.index_order(got_ts) == tuple(range(len(ids)))


def test_starts_of_a_file_network(nets, fused, tmp_path):
    path = tmp_path / 'starts.json'
    paths.write_starts(path, fused, 3)
    ts_inds, out, dims = networks.build(fused)
    assert out
    assert paths.load_starts(path, fused, 3) == [
        paths.random_path(ts_inds, out, dims, s) for s in range(3)]
    with pytest.raises(ValueError):
        paths.load_starts(path, {'file': 'open'}, 3)


# ----------------------------------------------------------- proposals ---


def _fake(engine):
    return types.SimpleNamespace(engine=engine, n_walks=8, n_replicas=5)


@pytest.mark.parametrize('engine', runners.WALK_ENGINES)
def test_walk_engines_propose_their_walks(engine):
    assert runners.proposals(_fake(engine), 2, 3, 100, 7) == 2 * 3 * 8 * 5


def test_a_sweep_round_proposes_at_every_internal_node():
    assert runners.proposals(_fake('sweep'), 2, 3, 100, 7) == 2 * 3 * 99 * 5


def test_batched_proposes_the_steps_it_walked():
    bound = 2 * 3 * 99 * 5
    for walked in (1, 1234, bound):
        assert runners.proposals(_fake('batched'), 2, 3, 100, walked) == \
            walked
    for walked in (0, -1, bound + 1):
        with pytest.raises(ValueError, match='outside'):
            runners.proposals(_fake('batched'), 2, 3, 100, walked)


@pytest.mark.parametrize('engine', ['vmapped', 'native', 'other'])
def test_other_engines_have_no_count(engine):
    with pytest.raises(ValueError, match=engine):
        runners.proposals(_fake(engine), 2, 3, 100, 7)


@pytest.mark.parametrize('n_leaves', [0, 1, 2, 51, 1649])
def test_the_sweep_bound_is_the_programs(n_leaves):
    assert runners.sweep_steps(n_leaves) == \
        sa_batched.max_walk_steps(n_leaves)


def _small_runner(network, engine, fw=False):
    cell = spec.cell(spec.load(), FW if fw else IM)
    config = {**cell['config'], **tiny(network, engine, fw=fw)['config']}
    ts_inds, out, dims = networks.build(network)
    starts = [paths.random_path(ts_inds, out, dims, s) for s in range(4)]
    runner = runners.build(config, ts_inds, out, dims,
                           networks.index_order(ts_inds), starts,
                           [1, 2, 3, 4], torch.device('cpu'))
    runners.widen(runner, list(range(100, 100 + B)))
    return runner, config, len(ts_inds)


def test_sweep_counts_what_the_harness_counts(fused):
    runner, config, n_leaves = _small_runner(fused, 'sweep')
    runners.run_chunk(runner, config, {}, np.ones(K, np.float32))
    assert runners.count_walked(runner) == runners.proposals(
        runner, 1, K, n_leaves, 0)


def _depth(par: np.ndarray, node: int) -> int:
    d = 0
    while par[node] >= 0:
        node, d = par[node], d + 1
    return d


@pytest.mark.parametrize('fw', [False, True])
def test_batched_walks_are_counted_step_by_step(fused, fw):
    """Each 'batched' sweep walks ``depth(leaf) - 1`` steps a replica,
    the leaf drawn as the engine draws it and its depth read off the
    replica's tree before the sweep: the runner's count, which the
    harness reports, equals that count of the harness's own."""
    runner, config, n_leaves = _small_runner(fused, 'batched', fw)
    traffic = {'update_slices': 0}
    total = 0
    for i in range(6):
        gen = torch.Generator()
        gen.set_state(runner.generator.get_state())
        leaves = sa_batched.draw_sweep(gen, n_leaves, B)['leaf'].tolist()
        want = sum(max(_depth(runner.ctree(r).nodes_array[:, 2], leaf) - 1,
                       0) for r, leaf in enumerate(leaves))
        w0 = runners.count_walked(runner)
        runners.run_chunk(runner, config, traffic,
                          np.full(1, 0.5 * i, np.float32))
        assert runners.count_walked(runner) - w0 == want
        total += want
    assert 0 < total < 6 * B * (n_leaves - 1)
    assert runners.proposals(runner, 6, 1, n_leaves, total) == total


# ------------------------------------------------------------- options ---


def test_run_options_reach_every_run_call():
    calls = []
    runner = types.SimpleNamespace(run=lambda betas, **kw: calls.append(kw))
    traffic = {'update_slices': 4, 'run_options': {'exchange_every': 2,
                                                   'chunk_size': 2}}
    runners.run_chunk(runner, {'runner': 'ReplicaRunnerFW'}, traffic,
                      np.ones(8, np.float32))
    runners.run_chunk(runner, {'runner': 'ReplicaRunner'}, {},
                      np.ones(8, np.float32))
    assert calls == [{'chunk_size': 2, 'exchange_every': 2,
                      'update_slices': 4}, {'chunk_size': 8}]
    traffic['run_options']['chunk_size'] = 3
    with pytest.raises(ValueError, match='divide'):
        runners.run_chunk(runner, {'runner': 'ReplicaRunnerFW'}, traffic,
                          np.ones(8, np.float32))


# ----------------------------------------------------- whole runs (CPU) ---


@pytest.fixture
def widened(monkeypatch):
    """The runners the harness widens, as it leaves them."""
    got = []
    real = runners.widen

    def spy(runner, seeds):
        real(runner, seeds)
        got.append(runner)

    monkeypatch.setattr(runners, 'widen', spy)
    return got


@pytest.mark.parametrize('workload', [IM, FW])
def test_batched_on_a_file_network(workload, fused, widened):
    fw = workload == FW
    out = harness.execute(workload, SEED, 0.2, False, device='cpu',
                          overrides=tiny(fused, fw=fw))
    assert out['correct'], out['checks']
    assert out['engine'] == 'batched'
    (runner,) = widened
    assert runner.n_replicas == B and runner.states.c0.shape[1] == B
    ts_inds, _, _ = networks.build(fused)
    assert 0 < out['proposals'] < (out['phases']['window_chunks'] * K * B *
                                   (len(ts_inds) - 1))
    rate = 'proposals_per_s.fw' if fw else 'proposals_per_s.im'
    assert out['metrics'][rate]['value'] > 0
    if fw:
        assert out['checks']['over_cap_nodes']['value'] == 0


def test_run_options_act_inside_a_run(fused, monkeypatch):
    exchanges = []
    real = replicas.exchange_best_fw

    def spy(*a, **k):
        exchanges.append(a)
        return real(*a, **k)

    monkeypatch.setattr(replicas, 'exchange_best_fw', spy)
    over = tiny(fused, fw=True, run_options={'chunk_size': 2,
                                             'exchange_every': 1})
    out = harness.execute(FW, SEED, 0.2, False, device='cpu',
                          overrides=over)
    assert out['correct'], out['checks']
    # Three exchanges inside each chunk of four run chunks.
    chunks = 1 + out['phases']['window_chunks']
    assert len(exchanges) == 3 * chunks


def test_a_traced_run_carries_spans_and_counts():
    from portbench.test_portbench_faults import tiny as cell_size
    over = cell_size(FW)
    over['config']['max_width'] = 8
    out = harness.execute(FW, SEED, 0.2, True, device='cpu', overrides=over)
    assert out['correct'], out['checks']
    assert list(out)[-3:] == ['spans', 'counts', 'checks']
    assert out['spans']['tnco.runner.chunk']['calls'] == 1
    # A chunk of 32 reslices at its steps 0, 10, 20, 30: each reads
    # whether any replica holds slices and the slicer's entry; the chunk
    # reads its applied count.
    assert out['counts']['host_reads'] == 2 * 4 + 1
    assert out['metrics']['host_reads_per_chunk.fw']['value'] == 2 * 4 + 1


def _spans_ctx(device_name, names):
    table = {n: {'calls': 2, 'host_s': 1.0, 'device_s': 0.01,
                 'idle_s': 0.0} for n in names}
    return harness.Context(device_name=device_name, spans=table,
                           traced={'chunks': 2})


def test_around_k5_reads_the_walker_spans_on_the_card():
    read = spec.reader('around_k5_ms.im')
    stages = ('tnco.walker.pack', 'tnco.walker.unpack',
              'tnco.walker.finish')
    card = 'NVIDIA H100 80GB HBM3'
    assert read(_spans_ctx(card, stages + ('tnco.walker.k5',))) == \
        pytest.approx(15.0)
    assert read(_spans_ctx('cpu', stages)) is None
    assert read(_spans_ctx(card, ('tnco.walks.claim',))) is None
    assert read(_spans_ctx(card, stages[:2])) is None
    assert read(harness.Context(device_name=card)) is None

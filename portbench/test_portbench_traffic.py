"""The frozen traffic: the network, the starting paths, the seeds and the
widening to the cell's replicas (CPU)."""

import json

import numpy as np
import pytest
import torch

from portbench import harness, networks, paths, runners, spec
from tnco_tpu_torch.utils.tn import get_random_contraction_path

SEEDS = (0, 7, 2**31 + 11)


@pytest.fixture(scope='module')
def sycamore():
    return networks.build({'generator': 'sycamore53', 'm_cycles': 20})


def test_network_has_the_published_counts(sycamore):
    ts_inds, output_inds, dims = sycamore
    couplers = networks.sycamore53_couplers()
    qubits = networks.sycamore53_qubits()
    assert len(qubits) == 53 and len(set(qubits)) == 53
    assert sum(map(len, couplers.values())) == 86
    for pattern in couplers.values():
        # Within a pattern no qubit takes two gates.
        touched = [q for pair in pattern for q in pair]
        assert len(touched) == len(set(touched))
    ranks = [len(xs) for xs in ts_inds]
    assert ranks.count(1) == 2 * 53          # the boundary states
    assert ranks.count(2) == 53 * 21         # 20 cycles and a half cycle
    assert ranks.count(4) == 430             # 5 of each pattern
    assert len(ts_inds) == 1649 and len(dims) == 2026
    assert output_inds == frozenset() and set(dims.values()) == {2}
    for cfg in ('syc53_m20_im', 'syc53_m20_fw30'):
        conf = json.loads((spec.HERE / 'configs' / f'{cfg}.json')
                          .read_text())
        assert (conf['tensors'], conf['indices'], conf['couplers'],
                conf['two_qubit_gates'], conf['single_qubit_gates']) == \
            (1649, 2026, 86, 430, 1113)


@pytest.mark.parametrize('seed', SEEDS)
def test_random_path_is_the_users_starting_path(sycamore, seed):
    ts_inds, output_inds, dims = sycamore
    want = get_random_contraction_path(ts_inds, output_inds,
                                       merge_paths=False, seed=seed)
    assert paths.random_path(ts_inds, output_inds, dims, seed) == \
        [tuple(x) for x in want[0]]


@pytest.mark.parametrize('workload', ['syc53_im_walker_b1024',
                                      'syc53_fw30_walks_b2048'])
def test_starts_file_holds_the_users_starting_paths(sycamore, workload):
    cell = spec.cell(spec.load(), workload)
    traffic = cell['traffic']
    ts_inds, output_inds, _ = sycamore
    starts = paths.load_starts(spec.starts_file(traffic['starts']),
                               cell['config']['network'],
                               traffic['distinct_trees'])
    assert len(starts) == traffic['distinct_trees']
    for seed, path in enumerate(starts):
        want = get_random_contraction_path(ts_inds, output_inds,
                                           merge_paths=False, seed=seed)
        assert path == [tuple(x) for x in want[0]], seed
    with pytest.raises(ValueError, match='holds paths of'):
        paths.load_starts(spec.starts_file(traffic['starts']),
                          {'generator': 'sycamore53', 'm_cycles': 4}, 1)


def test_random_path_refuses_a_disconnected_network():
    with pytest.raises(ValueError, match='not connected'):
        paths.random_path([('a',), ('b',)], frozenset(), {'a': 2, 'b': 2},
                          0)


@pytest.mark.parametrize('seed', SEEDS)
def test_seeds_follow_the_seed_alone(seed):
    a = harness._seeds(seed, 1024, 64)
    assert a == harness._seeds(seed, 1024, 64)
    replica_seeds, sample = a
    assert len(set(replica_seeds)) > 1000 and len(replica_seeds) == 1024
    assert len(set(sample)) == 64 and max(sample) < 1024
    assert a != harness._seeds(seed + 1, 1024, 64)


def test_betas_rise_then_hold():
    traffic = {'anneal_iterations': 256, 'beta_max': 60.0}
    b = np.concatenate([harness._betas(traffic, i, 128) for i in
                        (0, 128, 256)])
    assert b[0] == 0.0 and b[255] < 60.0 and np.all(b[256:] == 60.0)
    assert np.all(np.diff(b[:257]) > 0)


@pytest.mark.parametrize('workload', ['syc53_im_walker_b1024',
                                      'syc53_fw30_walks_b2048'])
def test_widening_repeats_the_replicas(workload):
    cell = spec.cell(spec.load(), workload)
    config = dict(cell['config'], network={'generator': 'sycamore53',
                                           'm_cycles': 4})
    if 'max_width' in config:
        config['max_width'] = 10
    ts_inds, output_inds, dims = networks.build(config['network'])
    order = networks.index_order(ts_inds)
    starts = [paths.random_path(ts_inds, output_inds, dims, s)
              for s in (1, 2, 3)]
    runner = runners.build(config, ts_inds, output_inds, dims, order,
                           starts, [11, 12, 13], 'cpu')
    before = runner.states
    seeds = list(range(100, 108))
    runners.widen(runner, seeds)
    st = runner.states
    assert runner.n_replicas == 8
    assert tuple(runner._mw_pos.shape) == (runner.n_walks, 8)
    assert (runner._lo, runner._hi) == (0, 8)
    for f in ('c0', 'c1', 'par', 'inds', 'min_inds', 'lcc',
              'min_log2_total'):
        got, base = getattr(st, f), getattr(before, f)
        for r in range(8):
            assert torch.equal(got[..., r], base[..., r % 3])
    assert st.keys[:, 1].tolist() == seeds

"""The port's finite-width runner and app on the walker path, end to end
on the CPU (engine 'walker', its plain route; engine 'multiwalk'), with
every result audited, and the JAX package's 'auto' routing."""

from decimal import Decimal

import numpy as np
import pytest
import torch

from benchmarks.networks import lattice_2d
from tnco_tpu.ctree import ContractionTree
from tnco_tpu.optimize.finite_width import SimpleCostModel as JCostModel
from tnco_tpu.parallel import replicas as jrep
from tnco_tpu.utils.tn import get_random_contraction_path
from tnco_tpu_torch.app import Optimizer, load_tn
from tnco_tpu_torch.app.finite_width.sa import _exact_component_cost
from tnco_tpu_torch.app.tn import Tensor, TensorNetwork
from tnco_tpu_torch.ctree import ContractionTree as TContractionTree
from tnco_tpu_torch.optimize.finite_width import SimpleCostModel
from tnco_tpu_torch.parallel import replicas as trep
from tnco_tpu_torch.parallel.replicas import ReplicaRunnerFW
from torch_reference_native import reference_native  # noqa: F401


def _network(net, rows=5, cols=5):
    ts, out, dims = lattice_2d(rows, cols)
    if net == 'mixed':
        r = np.random.default_rng(0)
        dims = {x: int(r.integers(2, 5)) for x in sorted(dims)}
    return ts, out, dims


def _trees(net, n, seed=0, rows=5, cols=5):
    ts, out, dims = _network(net, rows, cols)
    return [TContractionTree(get_random_contraction_path(
        ts, out, seed=seed + i), ts, dims, output_inds=out) for i in range(n)]


def _bits(ctree):
    return np.unpackbits(ctree.inds_array.view(np.uint8), axis=1,
                         bitorder='little')[:, :ctree.n_inds].astype(bool)


def _audit_replica(tree, lanes, max_width, device_total=None):
    """Valid tree, widths within the cap after slicing, and the device
    total equal to the exact sliced total (to f32)."""
    assert tree.is_valid(check_shared_inds=True)
    sl = np.unpackbits(lanes.view(np.uint8), bitorder='little').astype(
        bool)[:tree.n_inds]
    bits = _bits(tree)
    log2d = tree.log2_dims_array
    assert ((bits & ~sl) @ log2d).max() <= max_width + 1e-9
    if device_total is not None:
        nodes = tree.nodes_array
        total = sum(2.0**float(((bits[nodes[i, 0]] | bits[nodes[i, 1]]) |
                                sl) @ log2d)
                    for i in range(len(nodes)) if nodes[i, 0] >= 0)
        assert abs(np.log2(total) - device_total) < 1e-5


@pytest.mark.parametrize('engine,net', [('walker', 'dim2'),
                                        ('walker', 'mixed'),
                                        ('multiwalk', 'dim2')])
def test_runner_end_to_end(random_seed, engine, net):
    ctrees = _trees(net, 4, random_seed)
    runner = ReplicaRunnerFW(ctrees, [random_seed + i for i in range(4)],
                             cmodel=SimpleCostModel(max_width=4),
                             engine=engine, device='cpu')
    assert runner.engine == engine and runner.n_walks == 8
    seen = []
    info = runner.run(np.linspace(0, 6, 10), update_slices=2, chunk_size=4,
                      callback=seen.append)
    assert runner.sweeps_done == 12                # padded last chunk
    assert info['moves'] == 12 * 4 * 8 and info['applied'] > 0
    assert [round(s['progress'], 2) for s in seen] == [0.4, 0.8, 1.0]
    mins = runner.log2_min_totals()
    np.testing.assert_array_equal(info['log2_min_total'], mins)
    assert any(runner.min_slices_lanes(r).any() for r in range(4))
    for r in range(4):
        _audit_replica(runner.min_ctree(r), runner.min_slices_lanes(r), 4.0,
                       mins[r])
        _audit_replica(runner.ctree(r), runner.slices_lanes(r), 4.0)


def test_walker_and_multiwalk_runners_agree(random_seed):
    """Same seeds, same generator streams: the walker route (its plain
    version on the CPU) and the multi-walk engine give one trajectory."""
    ctrees = _trees('dim2', 3, random_seed, 4, 5)
    seeds = [random_seed + i for i in range(3)]
    runs = [ReplicaRunnerFW(ctrees, seeds, cmodel=SimpleCostModel(
        max_width=3), engine=e, device='cpu') for e in ('walker',
                                                        'multiwalk')]
    for runner in runs:
        runner.run(np.linspace(0, 4, 9), update_slices=2, chunk_size=4)
    for f in ('c0', 'c1', 'par', 'inds', 'lcc', 'width', 'slices',
              'min_slices', 'min_log2_total'):
        assert torch.equal(getattr(runs[0].states, f),
                           getattr(runs[1].states, f)), f
    assert runs[0].applied_done == runs[1].applied_done > 0


def test_runner_options_and_unported_paths():
    ctrees = _trees('dim2', 1, 1, 4, 4)
    kw = dict(cmodel=SimpleCostModel(max_width=3), device='cpu')
    with pytest.raises(ValueError, match="engine='walker'"):
        ReplicaRunnerFW(ctrees, [1], engine='walker', on_block='restart',
                        **kw)
    # The walk schedules are ported: 'dedup' builds.
    assert ReplicaRunnerFW(ctrees, [1], engine='multiwalk', on_block='dedup',
                           **kw).on_block == 'dedup'
    with pytest.raises(ValueError, match='max_number_new_slices'):
        ReplicaRunnerFW(ctrees, [1], engine='walker',
                        max_number_new_slices=2, **kw)
    runner = ReplicaRunnerFW(ctrees, [1], engine='walker', n_walks=3, **kw)
    assert runner.run([1.0] * 4, timeout=-1.0)['sweeps'] == 0
    runner.run([1.0] * 4, chunk_size=1, update_slices=2, exchange_every=1)
    assert runner.ctree(0).is_valid(check_shared_inds=True)
    assert runner.min_ctree(0).is_valid(check_shared_inds=True)
    # Without a mesh exchange_axes is not used, as in the JAX runner.
    runner.run([1.0], exchange_every=1, exchange_axes=('ici',))
    assert runner.min_ctree(0).is_valid(check_shared_inds=True)
    wide = _trees('dim2', 1, 0, 46, 46)             # 4140 indices: W = 130
    assert wide[0].inds_array.shape[1] > 123
    with pytest.raises(ValueError, match='walker_supported_fw'):
        ReplicaRunnerFW(wide, [1], engine='walker', **kw)


def test_auto_never_picks_walker(monkeypatch):
    """'auto' keeps the JAX rule on a large network on a device: 'walks',
    never 'walker' (``replicas.py:689-708``)."""
    from tnco_tpu import native
    ts, out, dims = lattice_2d(26, 26)
    path = get_random_contraction_path(ts, out, seed=0)
    monkeypatch.setattr(jrep, '_accel_available', lambda: True)
    monkeypatch.setattr(native, 'available', lambda: False)
    monkeypatch.setattr(trep, '_native_available', lambda: False)
    want = jrep.ReplicaRunnerFW(
        [ContractionTree(path, ts, dims, output_inds=out)], [0],
        cmodel=JCostModel(max_width=40)).engine
    monkeypatch.setattr(trep, '_accel_available', lambda device: True)
    got = ReplicaRunnerFW([TContractionTree(path, ts, dims, output_inds=out)],
                          [0], cmodel=SimpleCostModel(max_width=40),
                          device='cpu').engine
    assert got == want == 'walks'


def test_device_none_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ReplicaRunnerFW(_trees('dim2', 1, 0, 3, 3), [0],
                        cmodel=SimpleCostModel(max_width=3), engine='walker')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Optimizer(max_width=3, engine='walker')


@pytest.mark.parametrize('net', ['dim2', 'mixed'])
def test_optimizer_walker_end_to_end(random_seed, net):
    """``Optimizer(max_width=…, engine='walker')`` returns results whose
    path is valid, whose cost is the exact sliced cost of the returned
    slices, and whose widths fit the cap after slicing."""
    ts, out, dims = _network(net)
    tn = TensorNetwork([Tensor(xs, tuple(dims[x] for x in xs)) for xs in ts],
                       output_inds=out)
    max_width = 4.0 if net == 'dim2' else 6.0
    opt = Optimizer(max_width=max_width, engine='walker', device='cpu',
                    seed=random_seed)
    _, res = opt.optimize(tn, betas=(0, 4), n_steps=12, n_runs=3,
                          update_slices=3, fuse=0)
    loaded = load_tn(tn, fuse=0)
    cm = SimpleCostModel(max_width=max_width)
    assert len(res) == 3 and res == sorted(res)
    assert any(r.slices for r in res)
    for r in res:
        ctree = TContractionTree(r.path, loaded.ts_inds, loaded.dims,
                                 output_inds=loaded.output_inds)
        exact = _exact_component_cost(ctree, cm, r.slices)
        assert r.disconnected_costs == [Decimal(exact)]
        assert r.cost == Decimal(0) + Decimal(exact)
        order = ctree.inds_order
        lanes = np.zeros(-(-len(order) // 32), dtype=np.uint32)
        for x in r.slices:
            i = order.index(x)
            lanes[i // 32] |= np.uint32(1 << (i % 32))
        _audit_replica(ctree, lanes, max_width)

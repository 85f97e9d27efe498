"""The port's infinite-memory runner and app, end to end on the CPU
(engine 'walker', its plain version), against the JAX package's 'auto'
routing and results schema."""

from decimal import Decimal
import json

import numpy as np
import pytest
import torch

from benchmarks.networks import lattice_2d
from tnco_tpu.app import app as japp
from tnco_tpu.app.tn import Tensor as JTensor, TensorNetwork as JTN
from tnco_tpu.ctree import ContractionTree
from tnco_tpu.parallel import replicas as jrep
from tnco_tpu.testing.utils import generate_random_tensors
from tnco_tpu.utils.tn import get_random_contraction_path
from tnco_tpu_torch.app import app as tapp
from tnco_tpu_torch.app import Optimizer, load_tn
from tnco_tpu_torch.app.infinite_memory.sa import _exact_component_cost
from tnco_tpu_torch.app.tn import Tensor, TensorNetwork
from tnco_tpu_torch.ctree import ContractionTree as TContractionTree
from tnco_tpu_torch.optimize.infinite_memory import SimpleCostModel
from tnco_tpu_torch.parallel import ReplicaRunner
from tnco_tpu_torch.parallel import replicas as trep
import tnco_tpu_torch.utils.tn as ttn_utils
from torch_reference_native import reference_native  # noqa: F401


def _tn(cls_t, cls_tn, ts, out, dims):
    return cls_tn([cls_t(xs, tuple(dims[x] for x in xs)) for xs in ts],
                  output_inds=out)


def _trees(rows, cols, n, seed=0):
    ts, out, dims = lattice_2d(rows, cols)
    return [TContractionTree(get_random_contraction_path(
        ts, out, seed=seed + i), ts, dims, output_inds=out)
        for i in range(n)]


@pytest.mark.parametrize('engine', ['walker', 'multiwalk'])
def test_runner_end_to_end(random_seed, engine):
    ctrees = _trees(5, 5, 4, random_seed)
    runner = ReplicaRunner(ctrees, [random_seed + i for i in range(4)],
                           engine=engine, device='cpu')
    assert runner.n_walks == 8
    seen = []
    info = runner.run(np.linspace(0, 6, 10), chunk_size=4,
                      callback=seen.append)
    assert runner.sweeps_done == 12                # padded last chunk
    assert info['moves'] == 12 * 4 * 8 and info['applied'] > 0
    assert [round(s['progress'], 2) for s in seen] == [0.4, 0.8, 1.0]
    mins = runner.log2_min_totals()
    np.testing.assert_array_equal(info['log2_min_total'], mins)
    idx, best = runner.best()
    assert best == mins.min() and mins[idx] == best
    for r in range(4):
        for tree in (runner.min_ctree(r), runner.ctree(r)):
            assert tree.is_valid(check_shared_inds=True)
        # The device min total is the exact total, to f32.
        exact = runner.min_ctree(r).total_cost_exact()
        assert abs(np.log2(float(exact)) - mins[r]) < 1e-5


def test_walker_and_multiwalk_runners_agree(random_seed):
    """Same seeds, same generator streams: the walker route (its plain
    version on the CPU) and the multi-walk engine give one trajectory."""
    ctrees = _trees(4, 5, 3, random_seed)
    seeds = [random_seed + i for i in range(3)]
    runs = [ReplicaRunner(ctrees, seeds, engine=e, device='cpu')
            for e in ('walker', 'multiwalk')]
    for runner in runs:
        runner.run(np.linspace(0, 4, 9), chunk_size=3)
    for f in ('c0', 'c1', 'par', 'inds', 'lcc', 'min_log2_total'):
        assert torch.equal(getattr(runs[0].states, f),
                           getattr(runs[1].states, f)), f


def test_runner_timeout_and_unported_paths():
    ctrees = _trees(4, 4, 1)
    runner = ReplicaRunner(ctrees, [1], engine='walker', device='cpu')
    info = runner.run([1.0] * 4, timeout=-1.0)
    assert info['sweeps'] == 0
    runner.run([1.0] * 4, chunk_size=1, exchange_every=1)
    assert runner.ctree(0).is_valid(check_shared_inds=True)
    assert runner.min_ctree(0).is_valid(check_shared_inds=True)
    # Without a mesh exchange_axes is not used, as in the JAX runner.
    runner.run([1.0], exchange_every=1, exchange_axes=('ici',))
    assert runner.min_ctree(0).is_valid(check_shared_inds=True)
    with pytest.raises(TypeError, match='DeviceMesh'):
        ReplicaRunner(ctrees, [1], engine='walker', mesh=object(),
                      device='cpu')
    with pytest.raises(NotImplementedError,
                       match='walker engine: dense cost model only'):
        ReplicaRunner(ctrees, [1], engine='walker', device='cpu',
                      cmodel=SimpleCostModel(sparse_inds=['h0_0'],
                                             n_projs=2))
    # The walk schedules are ported: 'dedup' builds and runs.
    dedup = ReplicaRunner(ctrees, [1], engine='multiwalk', on_block='dedup',
                          device='cpu')
    assert dedup.on_block == 'dedup'
    dedup.run([1.0] * 4, chunk_size=2)
    assert dedup.min_ctree(0).is_valid(check_shared_inds=True)
    with pytest.raises(ValueError, match="engine='walker'"):
        ReplicaRunner(ctrees, [1], engine='walker', on_block='restart',
                      device='cpu')
    with pytest.raises(ValueError, match='One seed'):
        ReplicaRunner(ctrees, [1, 2], engine='walker', device='cpu')
    with pytest.raises(ValueError, match='Unknown engine'):
        ReplicaRunner(ctrees, [1], engine='nope', device='cpu')
    wide = _trees(46, 46, 1)                    # 4140 indices: W = 130
    assert wide[0].inds_array.shape[1] > 124
    with pytest.raises(ValueError, match='walker_supported'):
        ReplicaRunner(wide, [1], engine='walker', device='cpu')


def _jax_engine(ctrees, monkeypatch, accel, **kw):
    """The JAX runner's engine with its native engine off; the port's is
    pinned off too (the native cases: tests/test_torch_native.py)."""
    from tnco_tpu import native
    monkeypatch.setattr(jrep, '_accel_available', lambda: accel)
    monkeypatch.setattr(native, 'available', lambda: False)
    monkeypatch.setattr(trep, '_native_available', lambda: False)
    return jrep.ReplicaRunner(ctrees, list(range(len(ctrees))), **kw).engine


@pytest.mark.parametrize('size,accel,kw,item', [
    ((4, 4), True, {}, None),
    ((26, 26), True, {}, None),
    ((26, 26), False, {}, 'vmapped'),
    ((26, 26), True, {'prob_kind': 'greedy'}, 'vmapped'),
])
def test_auto_engine_matches_jax_rule(monkeypatch, size, accel, kw, item):
    ts, out, dims = lattice_2d(*size)
    path = get_random_contraction_path(ts, out, seed=0)
    want = _jax_engine([ContractionTree(path, ts, dims, output_inds=out)],
                       monkeypatch, accel, **kw)
    monkeypatch.setattr(trep, '_accel_available', lambda device: accel)
    ctrees = [TContractionTree(path, ts, dims, output_inds=out)]
    nw = len(ctrees[0]) * ctrees[0].inds_array.shape[1]
    assert (nw > 32768) == (size == (26, 26))
    assert ReplicaRunner(ctrees, [0], device='cpu', **kw).engine == want
    assert want in (('batched', 'walker') if item is None else (item,))


def test_device_none_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ReplicaRunner(_trees(3, 3, 1), [0], engine='walker')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Optimizer()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Optimizer(max_width=float('inf'))


def _optimize(mod_app, tn, seed, **kw):
    opt = mod_app.Optimizer(seed=seed, engine='walker', **kw)
    return opt.optimize(tn, betas=(0, 4), n_steps=6, n_runs=3, fuse=0)


def test_optimizer_end_to_end_and_schema(random_seed):
    ts, out, dims = lattice_2d(4, 5)
    tn = _tn(Tensor, TensorNetwork, ts, out, dims)
    tn_out, res = _optimize(tapp, tn, random_seed, device='cpu')
    loaded = load_tn(tn, fuse=0)
    cm = SimpleCostModel()
    assert res == sorted(res) and len(res) == 3
    for r in res:
        ctree = TContractionTree(r.path, loaded.ts_inds, loaded.dims,
                                 output_inds=loaded.output_inds)
        assert ctree.is_valid(check_shared_inds=True)
        exact = _exact_component_cost(ctree, cm)
        assert r.disconnected_costs == [Decimal(exact)]
        assert r.cost == Decimal(0) + Decimal(exact)
        assert r.disconnected_paths == [r.path]

    # Same results schema as the JAX package's app.
    _, jres = _optimize(japp, _tn(JTensor, JTN, ts, out, dims), random_seed)
    mine = json.loads(res[0].to_json())
    theirs = json.loads(jres[0].to_json())
    assert sorted(mine) == sorted(theirs)
    assert {k: type(v).__name__ for k, v in mine.items()} == \
        {k: type(v).__name__ for k, v in theirs.items()}
    assert type(res[0]).__name__ == type(jres[0]).__name__


def test_optimizer_disconnected_components(random_seed):
    ts, out, dims = generate_random_tensors(random_seed, n_tensors=12,
                                            n_ccs=2, n_output_inds=1)
    tn = _tn(Tensor, TensorNetwork, ts, out, dims)
    _, res = _optimize(tapp, tn, random_seed, device='cpu')
    loaded = load_tn(tn, fuse=0)
    n_cc = len(ttn_utils.get_connected_components(loaded.ts_inds))
    assert n_cc == 2
    for r in res:
        assert len(r.disconnected_costs) == len(r.disconnected_paths) == n_cc
        assert r.cost == Decimal(sum(r.disconnected_costs))
        assert r.path == ttn_utils.merge_contraction_paths(
            loaded.n_tensors, r.disconnected_paths)
        assert all(c > 0 for c in r.disconnected_costs)

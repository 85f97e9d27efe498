"""The port's runner and app layer, end to end on the CPU (engine
'walks'), against the JAX package's schema and 'auto' routing."""

from decimal import Decimal
import json

import numpy as np
import pytest
import torch

from benchmarks.networks import lattice_2d
from tnco_tpu.app import app as japp
from tnco_tpu.app.tn import Tensor as JTensor, TensorNetwork as JTN
from tnco_tpu.ctree import ContractionTree
from tnco_tpu.optimize.finite_width import SimpleCostModel as JCostModel
from tnco_tpu.parallel import replicas as jrep
from tnco_tpu.utils.tn import get_random_contraction_path
from tnco_tpu_torch.app import app as tapp
from tnco_tpu_torch.app import Optimizer, dump_results, load_tn
from tnco_tpu_torch.app.tn import Tensor, TensorNetwork
from tnco_tpu_torch.ctree import ContractionTree as TContractionTree
from tnco_tpu_torch.optimize.finite_width import SimpleCostModel
from tnco_tpu_torch.parallel import replicas as trep
from tnco_tpu_torch.parallel.replicas import ReplicaRunnerFW
from torch_reference_native import reference_native  # noqa: F401


def _tn(cls_t, cls_tn, rows, cols):
    ts, out, dims = lattice_2d(rows, cols)
    return cls_tn([cls_t(xs, tuple(dims[x] for x in xs)) for xs in ts],
                  output_inds=out)


def _width_ok(ctree, slices_mask, max_width):
    n = ctree.n_inds
    bits = np.unpackbits(ctree.inds_array.view(np.uint8), axis=1,
                         bitorder='little')[:, :n].astype(bool)
    widths = (bits & ~slices_mask[:n]) @ ctree.log2_dims_array
    return widths.max() <= max_width + 1e-9


def test_runner_end_to_end(random_seed):
    ts, out, dims = lattice_2d(5, 5)
    ctrees = [TContractionTree(get_random_contraction_path(
        ts, out, seed=random_seed + i), ts, dims, output_inds=out)
        for i in range(4)]
    runner = ReplicaRunnerFW(ctrees, [random_seed + i for i in range(4)],
                             cmodel=SimpleCostModel(max_width=4),
                             engine='walks', n_walks=8, device='cpu')
    seen = []
    info = runner.run(np.linspace(0, 6, 10), update_slices=2, chunk_size=4,
                      callback=seen.append)
    assert runner.sweeps_done == 12                # padded last chunk
    assert info['moves'] == 12 * 4 * 8 and info['applied'] > 0
    assert [round(s['progress'], 2) for s in seen] == [0.4, 0.8, 1.0]
    mins = runner.log2_min_totals()
    np.testing.assert_array_equal(info['log2_min_total'], mins)
    for r in range(4):
        for tree, lanes in ((runner.min_ctree(r), runner.min_slices_lanes(r)),
                            (runner.ctree(r), runner.slices_lanes(r))):
            assert tree.is_valid(check_shared_inds=True)
            mask = np.unpackbits(lanes.view(np.uint8), bitorder='little')
            assert _width_ok(tree, mask.astype(bool), 4.0)
        # The device min total is the exact sliced total, to f32.
        best = runner.min_ctree(r)
        mask = np.unpackbits(runner.min_slices_lanes(r).view(np.uint8),
                             bitorder='little').astype(bool)[:best.n_inds]
        bits = np.unpackbits(best.inds_array.view(np.uint8), axis=1,
                             bitorder='little')[:, :best.n_inds].astype(bool)
        nodes = best.nodes_array
        total = sum(2**int(((bits[nodes[i, 0]] | bits[nodes[i, 1]]) |
                            mask).sum())
                    for i in range(len(nodes)) if nodes[i, 0] >= 0)
        assert abs(np.log2(total) - mins[r]) < 1e-5


def test_runner_timeout_and_unported_paths():
    ts, out, dims = lattice_2d(4, 4)
    ctrees = [TContractionTree(get_random_contraction_path(ts, out, seed=1),
                               ts, dims, output_inds=out)]
    kw = dict(cmodel=SimpleCostModel(max_width=3), engine='walks',
              device='cpu')
    runner = ReplicaRunnerFW(ctrees, [1], **kw)
    assert runner.n_walks == 128
    info = runner.run([1.0] * 4, timeout=-1.0)
    assert info['sweeps'] == 0
    # Exchange runs between chunks (one replica: no lane is worse than
    # its island best, so the state anneals as without it).
    runner.run([1.0] * 4, chunk_size=1, update_slices=2, exchange_every=1)
    assert runner.ctree(0).is_valid(check_shared_inds=True)
    assert runner.min_ctree(0).is_valid(check_shared_inds=True)
    # Without a mesh exchange_axes is not used, as in the JAX runner.
    runner.run([1.0], exchange_every=1, exchange_axes=('ici',))
    assert runner.min_ctree(0).is_valid(check_shared_inds=True)
    with pytest.raises(TypeError, match='DeviceMesh'):
        ReplicaRunnerFW(ctrees, [1], mesh=object(), **kw)
    with pytest.raises(ValueError, match='One seed'):
        ReplicaRunnerFW(ctrees, [1, 2], **kw)


def _optimize(mod_app, tn, seed, **kw):
    opt = mod_app.Optimizer(max_width=4, seed=seed, engine='walks',
                            n_walks=8, **kw)
    return opt, opt.optimize(tn, betas=(0, 4), n_steps=6, n_runs=3,
                             update_slices=2, fuse=0)


def test_optimizer_end_to_end_and_schema(random_seed):
    tn = _tn(Tensor, TensorNetwork, 5, 5)
    _, (tn_out, res) = _optimize(tapp, tn, random_seed, device='cpu')
    loaded = load_tn(tn, fuse=0)
    cm = SimpleCostModel(max_width=4)
    for r in res:
        ctree = TContractionTree(r.path, loaded.ts_inds, loaded.dims,
                                 output_inds=loaded.output_inds)
        assert ctree.is_valid(check_shared_inds=True)
        inds, dims = ctree.inds, ctree.dims
        exact = sum(cm.contraction_cost(inds[n.children[0]],
                                        inds[n.children[1]], inds[i], dims,
                                        r.slices)
                    for i, n in enumerate(ctree.nodes) if not n.is_leaf())
        assert r.disconnected_costs == [Decimal(exact)]
        assert r.cost == Decimal(0) + Decimal(exact)
        order = ctree.inds_order
        mask = np.zeros(len(order) + 32, dtype=bool)
        mask[[order.index(x) for x in r.slices]] = True
        assert _width_ok(ctree, mask, 4.0)
    assert res == sorted(res)

    # Same results schema as the JAX package's app.
    jtn = _tn(JTensor, JTN, 5, 5)
    _, (_, jres) = _optimize(japp, jtn, random_seed)
    mine = json.loads(res[0].to_json())
    theirs = json.loads(jres[0].to_json())
    assert sorted(mine) == sorted(theirs)
    assert {k: type(v).__name__ for k, v in mine.items()} == \
        {k: type(v).__name__ for k, v in theirs.items()}
    assert type(res[0]).__name__ == type(jres[0]).__name__


def test_optimizer_same_seed_same_json(random_seed):
    tn = _tn(Tensor, TensorNetwork, 4, 5)
    docs = []
    for _ in range(2):
        _, (tn_out, res) = _optimize(tapp, tn, random_seed, device='cpu')
        doc = json.loads(dump_results(tn_out, res, output_format='json'))
        for r in doc['res']:
            r.pop('runtime_s')
        docs.append(doc)
    assert docs[0] == docs[1]


def test_optimizer_device_rule_and_unported(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Optimizer(max_width=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ReplicaRunnerFW([], [], cmodel=SimpleCostModel(max_width=4))
    from tnco_tpu_torch.app.infinite_memory.sa import Optimizer as IMOpt
    assert isinstance(Optimizer(device='cpu'), IMOpt)
    # QASM loads since the circuit front door was ported; the network
    # equals the JAX package's.
    qasm = 'OPENQASM 2.0;\nqreg q[1];\nh q[0];\nt q[0];\n'
    for kw in (dict(), dict(fuse=0, final_state=None)):
        got, want = load_tn(qasm, **kw), japp.load_tn(qasm, **kw)
        assert got.ts_inds == want.ts_inds
        assert got.output_inds == want.output_inds
        for a, b in zip(got.arrays, want.arrays):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    tn = load_tn([[2, 'a', 'b'], [2, 'b', 'c']], fuse=0)
    assert tn.n_tensors == 3


def _jax_engine(ctrees, monkeypatch, accel, **kw):
    """The JAX runner's engine with its native engine off; the port's is
    pinned off too (the native cases: tests/test_torch_native.py)."""
    from tnco_tpu import native
    monkeypatch.setattr(jrep, '_accel_available', lambda: accel)
    monkeypatch.setattr(native, 'available', lambda: False)
    monkeypatch.setattr(trep, '_native_available', lambda: False)
    return jrep.ReplicaRunnerFW(ctrees, list(range(len(ctrees))),
                                cmodel=JCostModel(max_width=40),
                                **kw).engine


@pytest.mark.parametrize('size,accel,kw', [
    ((4, 4), True, {}),
    ((26, 26), True, {}),
    ((26, 26), False, {}),
    ((26, 26), True, {'prob_kind': 'greedy'}),
])
def test_auto_engine_matches_jax_rule(monkeypatch, size, accel, kw):
    ts, out, dims = lattice_2d(*size)
    path = get_random_contraction_path(ts, out, seed=0)
    want = _jax_engine([ContractionTree(path, ts, dims, output_inds=out)],
                       monkeypatch, accel, **kw)
    monkeypatch.setattr(trep, '_accel_available', lambda device: accel)
    ctrees = [TContractionTree(path, ts, dims, output_inds=out)]
    args = dict(cmodel=SimpleCostModel(max_width=40), device='cpu', **kw)
    assert want in ('walks', 'batched', 'vmapped')
    assert ReplicaRunnerFW(ctrees, [0], **args).engine == want

"""End-to-end path replay and execution through the port: the counterpart
of ``tests/test_contraction.py``'s tests, with the port's optimizers and
runner on ``device='cpu'``.  A random network (the port's generator,
equal to the reference's for one seed) is optimized; the returned
``min_ctree.path()`` is replayed in pure Python with hyper-count
bookkeeping (exact bigint cost, equal to the optimizer's), its widths
after slicing are audited against ``max_width``, and the path is
executed with the port's ``utils.tn.contract`` / ``contract_sliced`` and
with the reference's executor on the same path and arrays.

Seeds and draws differ between the packages (a ``torch.Generator``
against threefry), so the paths are the port's own.  Tolerance: costs
exact; executions within 1e-10 (relative, and absolute to the result's
largest entry) of the reference's, and of a dense ``np.einsum``."""

import functools as fts
import math
import operator as op
import string

import numpy as np
import pytest

from tnco_tpu.utils import tn as jtn
from tnco_tpu_torch.ctree import ContractionTree
from tnco_tpu_torch.optimize.finite_width import (
    Optimizer as FWOptimizer, SimpleCostModel as FWCostModel)
from tnco_tpu_torch.optimize.infinite_memory import Optimizer, SimpleCostModel
from tnco_tpu_torch.optimize.prob import MetropolisHastings
from tnco_tpu_torch.parallel.replicas import ReplicaRunner
from tnco_tpu_torch.testing.utils import generate_random_tensors
from tnco_tpu_torch.utils.tn import (contract, contract_sliced,
                                     get_hyper_count,
                                     get_random_contraction_path,
                                     merge_contraction_paths)
from torch_reference_native import reference_native  # noqa: F401

RTOL = 1e-10


def _replay_cost(path, ts_inds, output_inds, dims, slices=frozenset(),
                 sparse=frozenset(), n_projs=None):
    """Pure-Python replay: total cost of a linear path with hyper rules
    (the sparse rule prod(dense) * min(prod(sparse), n_projs) when
    ``sparse`` is given)."""
    ts = [frozenset(xs) for xs in ts_inds]
    hyper_count = get_hyper_count(ts_inds, output_inds=output_inds)
    total = 0
    for x, y in (sorted(p) for p in path):
        ys = ts.pop(y)
        xs = ts.pop(x)
        union = xs | ys | frozenset(slices)
        dense = fts.reduce(op.mul,
                           (dims[i] for i in union if i not in sparse), 1)
        sp = fts.reduce(op.mul, (dims[i] for i in union if i in sparse), 1)
        total += dense * (min(sp, n_projs) if sparse else sp)
        shared = xs & ys
        zs = xs ^ ys
        for i in shared:
            assert hyper_count[i] > 0
            hyper_count[i] -= 1
            if hyper_count[i] > 0:
                zs |= {i}
        ts.append(zs)
    assert len(ts) == 1
    return total


def _tree(ts_inds, output_inds, dims, seed):
    paths = get_random_contraction_path(ts_inds, output_inds,
                                        merge_paths=False, seed=seed)
    (path,) = [p for p in paths if p]
    return ContractionTree(path, ts_inds, dims, output_inds=output_inds,
                           check_shared_inds=True)


def _arrays(ts_inds, dims, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal([dims[x] for x in xs]) for xs in ts_inds]


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * max(1.0, np.abs(want).max()))


def _inner(slices, output_inds, dims, max_passes=64):
    """The slices an execution projects: not the output indices, which
    ``contract_sliced`` refuses (the FW slicer may slice them), and, in
    sorted order, no more than ``max_passes`` slice assignments (one
    contraction each, in both packages)."""
    out, passes = [], 1
    for x in sorted(frozenset(slices) - frozenset(output_inds), key=repr):
        if passes * dims[x] <= max_passes:
            out.append(x)
            passes *= dims[x]
    return tuple(out)


def _execute(path, ts_inds, output_inds, dims, seed, slices=()):
    """The path executed by the port and by the reference on the same
    arrays (sliced when ``slices`` is given): equal within RTOL."""
    arrays = _arrays(ts_inds, dims, seed)
    if slices:
        got_ts, got_out, (got,) = contract_sliced(
            path, ts_inds, slices, output_inds, arrays=list(arrays))
        want_ts, want_out, (want,) = jtn.contract_sliced(
            path, ts_inds, slices, output_inds, arrays=list(arrays))
    else:
        got_ts, got_out, (got,) = contract(path, ts_inds, output_inds,
                                           arrays=list(arrays))
        want_ts, want_out, (want,) = jtn.contract(
            path, ts_inds, output_inds, arrays=list(arrays))
    assert len(got_ts) == len(want_ts) == 1
    assert frozenset(got_ts[0]) == frozenset(want_ts[0])
    assert frozenset(got_out) == frozenset(want_out)
    got = np.transpose(np.asarray(got),
                       [got_ts[0].index(x) for x in want_ts[0]])
    _close(got, want)
    return arrays, got


@pytest.mark.parametrize('hyper', [False, True])
def test_replay_infinite_memory(hyper, rng, random_seed):
    ts_inds, output_inds, dims = generate_random_tensors(
        rng, n_output_inds=2, n_hyper_edges=2 if hyper else 0,
        n_hyper_output_inds=1 if hyper else 0)
    ctree = _tree(ts_inds, output_inds, dims, random_seed)
    opt = Optimizer(ctree, SimpleCostModel(), seed=random_seed, device='cpu')
    opt.update_many(MetropolisHastings(), [b * 0.5 for b in range(100)])
    assert opt.is_valid()

    path = opt.min_ctree.path()
    replayed = _replay_cost(path, ts_inds, output_inds, dims)
    assert replayed == int(opt.min_total_cost)
    assert replayed == opt.min_ctree.total_cost_exact()
    assert replayed <= ctree.total_cost_exact()
    _execute(path, ts_inds, output_inds, dims, random_seed)


def test_replay_finite_width(rng, random_seed):
    ts_inds, output_inds, dims = generate_random_tensors(rng,
                                                         n_output_inds=2)
    ctree = _tree(ts_inds, output_inds, dims, random_seed)
    opt = FWOptimizer(ctree, FWCostModel(max_width=3.0), seed=random_seed,
                      device='cpu')
    opt.update_many(MetropolisHastings(), [b * 0.5 for b in range(60)],
                    update_slices_every=10)
    assert opt.is_valid()

    slices = opt.min_slices
    path = opt.min_ctree.path()
    replayed = _replay_cost(path, ts_inds, output_inds, dims, slices)
    assert replayed == int(opt.min_total_cost)
    _execute(path, ts_inds, output_inds, dims, random_seed,
             _inner(slices, output_inds, dims))


def test_replay_sparse_inds(rng, random_seed):
    """Sparse-index cost model end to end (simple_sparse_inds.hpp rule)."""
    ts_inds, output_inds, dims = generate_random_tensors(
        rng, min_n_tensors=6, use_mixed_labels=False)
    inner = sorted({x for xs in ts_inds for x in xs} - set(output_inds))
    k = rng.randint(1, max(1, len(inner) // 3))
    sparse = frozenset(rng.sample(inner, k))
    n_projs = rng.randint(1, 32)
    ctree = _tree(ts_inds, output_inds, dims, random_seed)
    opt = Optimizer(ctree,
                    SimpleCostModel(sparse_inds=sparse, n_projs=n_projs),
                    seed=random_seed, device='cpu')
    opt.update_many(MetropolisHastings(), [b * 0.5 for b in range(80)])
    path = opt.min_ctree.path()
    replayed = _replay_cost(path, ts_inds, output_inds, dims,
                            sparse=sparse, n_projs=n_projs)
    assert replayed == int(opt.min_total_cost)
    _execute(path, ts_inds, output_inds, dims, random_seed)


def test_replay_fw_width_respected(rng, random_seed):
    """Every min-tree tensor fits max_width once min_slices are removed
    (reference greedy/optimizer.hpp:405-423 validity rule), by the
    tree's index sets and by the cost model's ``get_max_width``."""
    ts_inds, output_inds, dims = generate_random_tensors(
        rng, min_n_tensors=6, n_output_inds=1)
    max_width = 2.0 + 2.0 * rng.random()
    ctree = _tree(ts_inds, output_inds, dims, random_seed)
    cmodel = FWCostModel(max_width=max_width)
    opt = FWOptimizer(ctree, cmodel, seed=random_seed, device='cpu')
    opt.update_many(MetropolisHastings(), [b * 0.5 for b in range(60)],
                    update_slices_every=10)
    slices = opt.min_slices
    for node_inds in opt.min_ctree.inds:
        w = sum(math.log2(dims[i]) for i in set(node_inds) - set(slices))
        assert w <= max_width + 1e-3
    assert cmodel.get_max_width(
        [xs - slices for xs in opt.min_ctree.inds], dims) <= max_width + 1e-3
    path = opt.min_ctree.path()
    replayed = _replay_cost(path, ts_inds, output_inds, dims, slices)
    assert replayed == int(opt.min_total_cost)
    _execute(path, ts_inds, output_inds, dims, random_seed,
             _inner(slices, output_inds, dims))


def test_fw_result_executes_sliced(rng, random_seed):
    """The FW optimizer's (path, min_slices) executes correctly: the
    sliced contraction equals a dense ``np.einsum`` of the network and the
    reference's ``contract_sliced`` of the same path."""
    ts_inds, output_inds, dims = generate_random_tensors(
        rng, n_tensors=6, n_output_inds=0, min_dim=2, max_dim=3,
        use_mixed_labels=False)
    letter = {x: string.ascii_letters[i]
              for i, x in enumerate(dict.fromkeys(
                  x for xs in ts_inds for x in xs))}
    sub = ','.join(''.join(letter[x] for x in xs) for xs in ts_inds)

    ctree = _tree(ts_inds, output_inds, dims, random_seed)
    opt = FWOptimizer(ctree, FWCostModel(max_width=1.5), seed=random_seed,
                      device='cpu')
    opt.update_many(MetropolisHastings(), [b * 0.5 for b in range(40)],
                    update_slices_every=10)

    slices = tuple(sorted(opt.min_slices))
    arrays, got = _execute(opt.min_ctree.path(), ts_inds, output_inds, dims,
                           random_seed, slices)
    _close(got, np.einsum(sub + '->', *arrays))


def test_replay_multiple_components(rng, random_seed):
    """Per-component paths merged replay and execute over the full TN
    (the app's flow, ``app/infinite_memory/sa.py``); the merge is the
    reference's."""
    ts_inds, output_inds, dims = generate_random_tensors(
        rng, min_n_tensors=8, max_n_tensors=14, n_ccs=2)
    paths = get_random_contraction_path(ts_inds, output_inds,
                                        merge_paths=False, seed=random_seed)
    if not any(paths):
        pytest.skip('all components are single tensors')
    merged = merge_contraction_paths(len(ts_inds), paths)
    assert merged == jtn.merge_contraction_paths(len(ts_inds), paths)
    total = _replay_cost(merged, ts_inds, output_inds, dims)
    assert total > 0
    _execute(merged, ts_inds, output_inds, dims, random_seed)


def test_replay_device_engine(rng, random_seed):
    """The replica runner ('batched', on the CPU) end to end: the best
    tree's replayed exact cost equals the engine's reported min log2
    total, and its path executes as the reference's executor does."""
    ts_inds, output_inds, dims = generate_random_tensors(
        rng, n_output_inds=1)
    order = tuple(dict.fromkeys(x for xs in ts_inds for x in xs))
    ctrees = []
    for r in range(4):
        paths = get_random_contraction_path(ts_inds, output_inds,
                                            merge_paths=False,
                                            seed=random_seed + r)
        (path,) = [p for p in paths if p]
        ctrees.append(
            ContractionTree(path, ts_inds, dims, output_inds=output_inds,
                            check_shared_inds=True, inds_order=order))
    runner = ReplicaRunner(ctrees, list(range(4)), engine='batched',
                           device='cpu')
    runner.run(np.linspace(0.0, 20.0, 50, dtype=np.float32), chunk_size=25)
    idx, best_log2 = runner.best()
    best_tree = runner.min_ctree(idx)
    path = best_tree.path()
    replayed = _replay_cost(path, ts_inds, output_inds, dims)
    assert replayed == best_tree.total_cost_exact()
    assert np.isclose(math.log2(replayed), best_log2, rtol=1e-5)
    _execute(path, ts_inds, output_inds, dims, random_seed)

"""The port's island exchange (``exchange_best``, ``exchange_best_fw`` and
the runners' ``exchange_every``) vs the JAX package's.

Both sides start from one state (the JAX batch carried across with
:mod:`tnco_tpu_torch.convert`), with pinned current totals that tie with
their island best and at the worst-k threshold.  Exchange only copies
columns, so every field, totals included, must be bitwise equal.  The
runner cases record the exchange calls between chunks on both sides.
"""

from random import Random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from benchmarks.networks import lattice_2d
from tnco_tpu.ctree import ContractionTree
from tnco_tpu.kernels import sa_batched as jsb
from tnco_tpu.kernels import sa_finite_batched as jsfb
from tnco_tpu.optimize.finite_width import SimpleCostModel as JFWModel
from tnco_tpu.optimize.infinite_memory import SimpleCostModel as JIMModel
from tnco_tpu.ops import bitops as jbit
from tnco_tpu.parallel import replicas as jrep
from tnco_tpu.testing.utils import generate_random_tensors
from tnco_tpu.utils.tn import get_random_contraction_path
from tnco_tpu_torch.convert import (batch_fw_from_numpy, batch_fw_to_numpy,
                                    batch_from_numpy, batch_to_numpy)
from tnco_tpu_torch.ctree import ContractionTree as TContractionTree
from tnco_tpu_torch.optimize.finite_width import SimpleCostModel as TFWModel
from tnco_tpu_torch.parallel import replicas as trep
from torch_reference_native import reference_native  # noqa: F401

B = 8
# Width caps: tight enough that every network holds slices.
MAX_WIDTH = {'stall': 3.0, 'lattice': 3.0, 'mixed': 6.0}


def network(kind, seed):
    """The nets of ``tests/test_stall.py`` (10 tensors on dims 2-4, a
    hyper index), a 4x4 lattice (dims 2) and a net on dims 2 and 3."""
    if kind == 'stall':
        return generate_random_tensors(Random(seed), n_tensors=10,
                                       n_hyper_edges=1, n_output_inds=1)
    if kind == 'lattice':
        return lattice_2d(4, 4)
    ts, out, dims = generate_random_tensors(
        seed, n_tensors=16, min_dim=2, max_dim=3, n_extra_edges=10,
        n_output_inds=1, use_mixed_labels=False)
    assert len(set(dims.values())) == 2
    return ts, out, dims


def tree_pairs(kind, seed, b=B):
    """``b`` initial trees of one network, JAX's and the port's, from the
    same random paths: ``(jax_trees, port_trees, (ts, out, dims, order))``."""
    ts, out, dims = network(kind, seed)
    order = tuple(dict.fromkeys(x for xs in ts for x in xs))
    jt, tt = [], []
    for r in range(b):
        (path,) = [p for p in get_random_contraction_path(
            ts, out, merge_paths=False, seed=seed + r) if p]
        for cls, acc in ((ContractionTree, jt), (TContractionTree, tt)):
            acc.append(cls(path, ts, dims, output_inds=out,
                           check_shared_inds=True, inds_order=order))
    return jt, tt, (ts, out, dims, order)


def fields(batch):
    return {k: np.asarray(getattr(batch, k)) for k in batch.__slots__}


def fw_runners(kind, seed, engine='walks', n_walks=4, b=B):
    """A JAX and a port ``ReplicaRunnerFW`` (the port on the CPU) from the
    same trees and seeds; the port's state and walk positions are then
    set to the JAX runner's, so both hold one state."""
    jt, tt, net = tree_pairs(kind, seed, b)
    seeds = [seed + r for r in range(b)]
    mw = MAX_WIDTH[kind]
    jr = jrep.ReplicaRunnerFW(jt, seeds, cmodel=JFWModel(max_width=mw),
                              engine=engine, n_walks=n_walks)
    tr = trep.ReplicaRunnerFW(tt, seeds, cmodel=TFWModel(max_width=mw),
                              engine=engine, n_walks=n_walks, device='cpu')
    sync_fw(jr, tr)
    return jr, tr, net


def sync_fw(jr, tr):
    """Sets the port runner's state and positions to the JAX runner's."""
    tr.states = batch_fw_from_numpy(fields(jr.states), 'cpu')
    tr._mw_pos = torch.from_numpy(np.asarray(jr._mw_pos).copy())


def _fw_batch(kind, seed):
    jt, _, _ = tree_pairs(kind, seed)
    w = jt[0].inds_array.shape[1]
    log2d = np.asarray(jbit.pad_log2_dims(jt[0].log2_dims_array, w))
    return jsfb.init_batch_fw(jt, [seed + r for r in range(B)],
                              MAX_WIDTH[kind], log2d)


def _im_batch(seed):
    jt, _, _ = tree_pairs('lattice', seed)
    w = jt[0].inds_array.shape[1]
    log2d = np.asarray(jbit.pad_log2_dims(jt[0].log2_dims_array, w))
    return jsb.init_batch(jt, [seed + r for r in range(B)], log2d)


def pinned_totals(offset=0.0):
    """Current totals over few values: at every island count, each island
    holds a lane strictly above its best, and there are ties with the
    best (2 islands of 4, or all 8 lanes) and at the worst-k threshold."""
    return (50.0 + offset +
            np.array([1, 0, 1, 3, 0, 2, 2, 3])).astype(np.float32)


def with_totals(batch, lt):
    """The JAX batch with its current totals replaced by ``lt``."""
    return type(batch)(**{**fields(batch), 'log2_total': jnp.asarray(lt)})


def _active(islands, gated):
    return (np.arange(islands) % 2 == 0) if gated else None


def _assert_fields_equal(want, got, what):
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=f'{what}: {k}')


@pytest.mark.parametrize('gated', [False, True])
@pytest.mark.parametrize('fraction', [0.25, 0.5])
@pytest.mark.parametrize('islands', [1, 2, 4])
@pytest.mark.parametrize('kind', ['stall', 'lattice', 'mixed'])
def test_exchange_best_fw_matches_jax(random_seed, kind, islands, fraction,
                                      gated):
    seed = random_seed % 1000
    batch = _fw_batch(kind, seed)
    lt = pinned_totals()
    batch = with_totals(batch, lt)
    active = _active(islands, gated)
    want = jrep.exchange_best_fw(batch, fraction, islands, active)
    got = trep.exchange_best_fw(batch_fw_from_numpy(fields(batch), 'cpu'),
                                fraction, islands, active)
    g = batch_fw_to_numpy(got)
    _assert_fields_equal(fields(want), g, f'{kind} G={islands}')
    moved = np.flatnonzero(np.asarray(want.log2_total) != lt)
    if not gated or islands > 1:
        assert moved.size, 'no lane was exchanged'


@pytest.mark.parametrize('gated', [False, True])
@pytest.mark.parametrize('fraction', [0.25, 0.5])
@pytest.mark.parametrize('islands', [1, 2, 4])
def test_exchange_best_matches_jax(random_seed, islands, fraction, gated):
    seed = random_seed % 1000
    batch = _im_batch(seed)
    lt = pinned_totals(0.5)
    batch = with_totals(batch, lt)
    active = _active(islands, gated)
    want = jrep.exchange_best(batch, fraction, islands, active)
    got = trep.exchange_best(batch_from_numpy(fields(batch), 'cpu'),
                             fraction, islands, active)
    _assert_fields_equal(fields(want), batch_to_numpy(got), f'G={islands}')


def test_exchange_ties_keep_trees_and_bad_islands(random_seed):
    """Lanes tied with their island best keep their own trees; min
    snapshots and keys stay; islands that do not divide B raise."""
    seed = random_seed % 1000
    batch = batch_fw_from_numpy(fields(_fw_batch('lattice', seed)), 'cpu')
    lt = torch.tensor([10.0, 10.0, 50, 60, 20.0, 20.0, 20.0, 61])
    batch.log2_total = lt
    out = trep.exchange_best_fw(batch, 0.5, 2)
    assert torch.equal(out.log2_total,
                       torch.tensor([10.0, 10.0, 10.0, 10.0, 20.0, 20.0,
                                     20.0, 20.0]))
    for i, src in ((1, 1), (2, 0), (3, 0), (5, 5), (6, 6), (7, 4)):
        assert torch.equal(out.c0[:, i], batch.c0[:, src]), i
        assert torch.equal(out.slices[:, i], batch.slices[:, src]), i
    for k in ('min_c0', 'min_inds', 'min_slices', 'min_log2_total', 'keys'):
        assert torch.equal(getattr(out, k), getattr(batch, k)), k
    for g in (3, 5, 16):
        with pytest.raises(ValueError, match='divide'):
            trep.exchange_best_fw(batch, islands=g)


def _record(monkeypatch, module, name, events):
    fn = getattr(module, name)

    def recorded(states, fraction, islands, *args):
        events.append(('exchange', float(fraction), int(islands)))
        return fn(states, fraction, islands, *args)
    monkeypatch.setattr(module, name, recorded)


@pytest.mark.parametrize('every', [1, 2, 3])
@pytest.mark.parametrize('fw', [False, True])
def test_runner_exchange_cadence_matches_jax(monkeypatch, random_seed, fw,
                                             every):
    """``run(exchange_every=k)`` exchanges after the same chunks as the
    JAX runner (``pos < n and n_chunks % k == 0``), with its fraction and
    islands."""
    seed = random_seed % 1000
    name = 'exchange_best_fw' if fw else 'exchange_best'
    jt, tt, _ = tree_pairs('lattice', seed)
    seeds = [seed + r for r in range(B)]
    logs = []
    for module, trees, kw in (
            (jrep, jt, {'cmodel': JFWModel(max_width=3.0)} if fw else
             {'cmodel': JIMModel()}),
            (trep, tt, dict({'cmodel': TFWModel(max_width=3.0)} if fw else {},
                            device='cpu'))):
        events = []
        _record(monkeypatch, module, name, events)
        cls = module.ReplicaRunnerFW if fw else module.ReplicaRunner
        runner = cls(trees, seeds, engine='batched', **kw)
        runner.run(np.linspace(0.0, 4.0, 11), chunk_size=2,
                   exchange_every=every, exchange_fraction=0.5,
                   exchange_islands=2,
                   callback=lambda m, events=events: events.append(
                       ('chunk', round(m['progress'], 4))))
        logs.append(events)
    assert logs[1] == logs[0]
    assert sum(e[0] == 'exchange' for e in logs[0]) == 5 // every


@pytest.mark.parametrize('engine', ['batched', 'walks', 'walker',
                                    'multiwalk'])
def test_fw_runner_anneals_with_exchange(random_seed, engine):
    """Every ported FW engine anneals with exchange between chunks: the
    best trees stay valid and within the cap after their slices, and the
    min totals never rise."""
    seed = random_seed % 1000
    _, tt, (ts, out, dims, order) = tree_pairs('lattice', seed)
    runner = trep.ReplicaRunnerFW(tt, list(range(B)),
                                  cmodel=TFWModel(max_width=3.0),
                                  engine=engine, n_walks=4, device='cpu')
    mins = [runner.log2_min_totals()]
    runner.run(np.linspace(0.0, 6.0, 12), chunk_size=2, update_slices=2,
               exchange_every=1, exchange_islands=2,
               callback=lambda m: mins.append(m['log2_min_total']))
    assert all((b <= a).all() for a, b in zip(mins, mins[1:]))
    for r in range(B):
        best = runner.min_ctree(r)
        assert best.is_valid(check_shared_inds=True)
        sl = np.unpackbits(runner.min_slices_lanes(r).view(np.uint8),
                           bitorder='little')[:best.n_inds].astype(bool)
        bits = np.unpackbits(best.inds_array.view(np.uint8), axis=1,
                             bitorder='little')[:, :best.n_inds].astype(bool)
        assert ((bits & ~sl) @ best.log2_dims_array).max() <= 3.0 + 1e-9
        assert runner.ctree(r).is_valid(check_shared_inds=True)


@pytest.mark.parametrize('engine', ['batched', 'walker', 'multiwalk'])
def test_im_runner_anneals_with_exchange(random_seed, engine):
    seed = random_seed % 1000
    _, tt, _ = tree_pairs('lattice', seed)
    runner = trep.ReplicaRunner(tt, list(range(B)), engine=engine,
                                n_walks=4, device='cpu')
    mins = [runner.log2_min_totals()]
    runner.run(np.linspace(0.0, 6.0, 12), chunk_size=2, exchange_every=1,
               exchange_fraction=0.5, exchange_islands=4,
               callback=lambda m: mins.append(m['log2_min_total']))
    assert all((b <= a).all() for a, b in zip(mins, mins[1:]))
    for r in range(B):
        assert runner.min_ctree(r).is_valid(check_shared_inds=True)
        assert runner.ctree(r).is_valid(check_shared_inds=True)


def test_exchange_axes_raise_naming_item_15():
    """``exchange_axes`` names mesh axes: without a mesh it is not used,
    as in the JAX runner, so the run equals one without it (the mesh
    cases: tests/test_torch_mesh.py)."""
    _, tt, _ = tree_pairs('lattice', 0, b=2)
    for make in (lambda: trep.ReplicaRunner(tt, [0, 1], engine='batched',
                                            device='cpu'),
                 lambda: trep.ReplicaRunnerFW(tt, [0, 1], engine='batched',
                                              cmodel=TFWModel(max_width=3.0),
                                              device='cpu')):
        a, b = make(), make()
        a.run([1.0, 2.0], exchange_every=1, exchange_axes=('ici',))
        b.run([1.0, 2.0], exchange_every=1)
        for f in ('c0', 'inds', 'lcc', 'min_log2_total'):
            assert torch.equal(getattr(a.states, f), getattr(b.states, f))


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['stall', 'lattice'])
def test_card_exchange_matches_cpu(random_seed, kind):
    """The card against the CPU on one exchange (islands 4, one island
    gated) and one of each kind of batch: every field bitwise."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    seed = random_seed % 1000
    active = np.array([True, False, True, True])
    for batch, exchange, to_numpy, from_numpy in (
            (with_totals(_fw_batch(kind, seed), pinned_totals()),
             trep.exchange_best_fw, batch_fw_to_numpy, batch_fw_from_numpy),
            (with_totals(_im_batch(seed), pinned_totals(0.5)),
             trep.exchange_best, batch_to_numpy, batch_from_numpy)):
        outs = [to_numpy(exchange(from_numpy(fields(batch), dev), 0.5, 4,
                                  active)) for dev in ('cpu', 'cuda')]
        _assert_fields_equal(outs[0], outs[1], f'{kind} card')

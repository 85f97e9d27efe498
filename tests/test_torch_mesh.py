"""The replica mesh on the CPU: four gloo ranks in subprocesses (one spawn
per test, each with its own time limit), against the one-device runner
and against the JAX package's sharded exchanges on its virtual CPU mesh
(``tests/conftest.py``)."""

import jax
import numpy as np
import pytest
import torch

from benchmarks.networks import lattice_2d
from tnco_tpu.ctree import ContractionTree
from tnco_tpu.kernels import sa_finite_batched as jsfb
from tnco_tpu.optimize.finite_width import SimpleCostModel as JFWModel
from tnco_tpu.parallel import replicas as jrep
from tnco_tpu.utils.tn import get_random_contraction_path
from tnco_tpu_torch import mesh as tmesh
from tnco_tpu_torch.kernels.sa_batched import SABatch as TSABatch
from tnco_tpu_torch.kernels.sa_finite_batched import SABatchFW as TSABatchFW
from tnco_tpu_torch.parallel.dryrun import dryrun_multichip
from tnco_tpu_torch.parallel.dryrun import main as dryrun_main
from tnco_tpu_torch.testing import mesh_cases as mc
from torch_reference_native import reference_native  # noqa: F401

N_RANKS = 4
B = 8


def _net(rows, cols, b, seed=0):
    ts, out, dims = lattice_2d(rows, cols)
    paths = [get_random_contraction_path(ts, out, seed=seed + i)
             for i in range(b)]
    return mc.network(ts, out, dims, paths)


def _same(got, want, what=''):
    """Deep bitwise equality of nested lists, tuples, dicts and arrays."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), what
        for k in want:
            _same(got[k], want[k], f'{what}.{k}')
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f'{what}[{i}]')
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, what
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert got == want, what


_BETAS = list(np.linspace(0, 6, 7))
_IM = [dict(fw=False, engine='batched', betas=_BETAS,
            run=dict(chunk_size=3)),
       dict(fw=False, engine='batched', run=dict(chunk_size=4),
            betas=np.linspace(0, 6, 5)[:, None].repeat(B, 1) +
            np.arange(B) / B),
       dict(fw=False, engine='vmapped', betas=_BETAS[:4],
            run=dict(chunk_size=2)),
       dict(fw=False, engine='multiwalk', kw=dict(n_walks=4), betas=_BETAS,
            run=dict(chunk_size=3)),
       dict(fw=False, engine='walks', kw=dict(n_walks=4), betas=_BETAS,
            run=dict(chunk_size=3)),
       dict(fw=False, engine='walker', kw=dict(n_walks=4), betas=_BETAS,
            run=dict(chunk_size=3))]
# The FW cases: every IM case but the per-lane betas one.
_FW = [dict(case, fw=True, max_width=4.0,
            run=dict(case['run'], update_slices=2))
       for i, case in enumerate(_IM) if i != 1]
# With the exchange every chunk over the mesh axes named (the one-device
# run takes mc.exchange_blocks between its chunks).
_IM.append(dict(fw=False, engine='batched', betas=_BETAS[:6],
                run=dict(chunk_size=2, exchange_every=1, exchange_axes=None,
                         exchange_fraction=0.5)))
_FW.append(dict(fw=True, engine='walks', max_width=4.0, kw=dict(n_walks=4),
                betas=_BETAS[:6],
                run=dict(chunk_size=2, update_slices=2, exchange_every=1,
                         exchange_axes=('ici',))))


@pytest.mark.parametrize('fw', [False, True], ids=['im', 'fw'])
@pytest.mark.parametrize('shape', [None, (2, 2)], ids=['1d', '2x2'])
def test_sharded_equals_one_device(shape, fw):
    """Every engine JAX shards ('batched', 'vmapped', 'multiwalk', 'walks',
    'walker'), infinite memory and finite width, on four ranks: each rank's
    block equals the one-device run's columns bitwise, and the counts and
    the (collective) accessors equal the one-device runner's; with the
    sharded exchange between chunks, the one-device run exchanges as the
    mesh does (``mesh_cases.exchange_blocks``)."""
    net = _net(4, 4, B)
    seeds = list(range(100, 100 + B))
    cases = _FW if fw else _IM
    names = ('r',) if shape is None else ('dcn', 'ici')
    cases = [dict(c, run=dict(c['run'], exchange_axes=names[-1:]))
             if c['run'].get('exchange_axes') else c for c in cases]
    spec = dict(net=net, seeds=seeds, cases=cases, shape=shape,
                axis_names=None if shape is None else names)
    ranks = tmesh.spawn(mc.sharded_runs, N_RANKS, (spec,), timeout=300)
    ctrees = mc.trees(net)
    for i, case in enumerate(cases):
        one = mc.build_runner(case, ctrees, seeds)
        info = mc.run_case(one, case, (shape or (N_RANKS,), names))
        views = mc.runner_views(one)
        what = f"{case['engine']}[{i}]"
        _same(mc.join_blocks([r[i]['local'] for r in ranks],
                             case['engine'] == 'vmapped'),
              mc.local_fields(one.states), what)
        _same(np.concatenate([r[i]['pos'] for r in ranks], axis=1),
              one._mw_pos.numpy(), what + '.pos')
        for rank in ranks:
            _same(rank[i]['info'], info, what + '.info')
            _same(rank[i]['views'], views, what + '.views')


@pytest.fixture(scope='module')
def jax_batches():
    """Two JAX-layout batches of B = 8 (IM and FW) after a few sweeps,
    so that their totals differ."""
    ts, out, dims = lattice_2d(4, 4)
    ctrees = [ContractionTree(get_random_contraction_path(ts, out, seed=i),
                              ts, dims, output_inds=out) for i in range(B)]
    im = jrep.ReplicaRunner(ctrees, list(range(B)), engine='batched')
    im.run(np.linspace(0, 3, 4), chunk_size=4)
    fw = jrep.ReplicaRunnerFW(ctrees, list(range(B)),
                              cmodel=JFWModel(max_width=4.0),
                              engine='batched')
    fw.run(np.linspace(0, 3, 4), chunk_size=4, update_slices=2)
    return im.states, fw.states


def _fields(batch):
    """A JAX batch's fields as numpy, by the port's field names."""
    cls = TSABatchFW if isinstance(batch, jsfb.SABatchFW) else TSABatch
    return {f: np.asarray(getattr(batch, f)) for f in cls.field_names()}


@pytest.mark.parametrize('fraction', [0.25, 1.0])
def test_exchange_sharded_matches_jax(jax_batches, fraction):
    """``exchange_best_sharded`` and ``exchange_best_fw_sharded`` on four
    gloo ranks of a (2, 2) ('dcn', 'ici') mesh equal JAX's on four devices
    of its virtual CPU mesh, bitwise, from one state, over 'ici', 'dcn'
    and all axes (uint32 words through the port's int32 layout)."""
    jmesh = jrep.make_mesh(jax.devices()[:N_RANKS], shape=(2, 2),
                           axis_names=('dcn', 'ici'))
    im, fw = jax_batches
    axes = [('ici',), ('dcn',), None]
    want = []
    for fn, batch in ((jrep.exchange_best_sharded, im),
                      (jrep.exchange_best_fw_sharded, fw)):
        for ax in axes:
            want.append(_fields(fn(batch, jmesh, ax, fraction)))
    spec = dict(shape=(2, 2), axis_names=('dcn', 'ici'), axes=axes,
                fraction=fraction,
                batches=[(False, _fields(im)), (True, _fields(fw))])
    ranks = tmesh.spawn(mc.exchange_cases, N_RANKS, (spec,), timeout=180)
    for i, w in enumerate(want):
        got = mc.join_blocks([r[i] for r in ranks])
        for f, x in w.items():
            y = got[f].view(np.uint32) if x.dtype == np.uint32 else got[f]
            np.testing.assert_array_equal(y, x, err_msg=f'{i}.{f}')


def test_mesh_rules():
    """'ici' exchange groups do not mix (the JAX test
    ``test_exchange_best_sharded_2d_mesh``), a mesh-wide exchange crosses
    'dcn', two of three axes form one group, and the runners refuse
    'sweep', a replica count that does not divide, and a non-mesh.  Each
    rank's replica block follows ``replica_sharding(mesh, axis_name)``:
    split over the axes named (row-major in their order), repeated along
    the others."""
    net = _net(3, 4, 16)
    ranks = tmesh.spawn(mc.mesh_rules, N_RANKS,
                        (dict(net=net, seeds=list(range(16))),), timeout=180)
    for k, rank in enumerate(ranks):
        dcn, ici = divmod(k, 2)
        assert rank.pop('blocks') == {
            'None': (k, 4), 'ici': (ici, 2), 'dcn': (dcn, 2),
            "('ici', 'dcn')": (2 * ici + dcn, 4)}, k
    r = ranks[0]
    before = r['before']
    g0, g1 = before[:8].min(), before[8:].min()
    np.testing.assert_array_equal(r['after_ici'][:8], np.full(8, g0))
    np.testing.assert_array_equal(r['after_ici'][8:], np.full(8, g1))
    np.testing.assert_array_equal(r['after_all'], np.full(16, min(g0, g1)))
    assert r['two_of_three'] and r['valid']
    errs = r['errors']
    assert errs['sweep'].startswith('ValueError') and 'multi-chip' in \
        errs['sweep']
    assert errs['sweep fw'].startswith('ValueError')
    assert errs['split'].startswith('ValueError') and 'split' in \
        errs['split']
    assert errs['not a mesh'].startswith('TypeError')
    for rank in ranks[1:]:
        _same(rank, r)


def test_dryrun_multichip_cpu(capsys):
    """The counterpart of ``__graft_entry__.dryrun_multichip(4)`` runs on
    four gloo ranks and asserts what the JAX dry run asserts."""
    line = dryrun_multichip(4, device='cpu')
    assert line.startswith('dryrun_multichip OK: 4 ranks')
    assert line in capsys.readouterr().out


@pytest.mark.skipif(torch.cuda.is_available(), reason='checks a host '
                    'without CUDA')
def test_dryrun_multichip_needs_the_card_by_default():
    """By the device rule the dry run's default is the cards: without
    CUDA it raises and asks for ``device='cpu'``, before any rank starts."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_multichip(4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_main(['4'])

"""Sparse indices through the port's engines vs the JAX package's.

A sparse cost model caps the sparse part of every cost and width at
``log2(n_projs)``.  The networks are the small ones of
``test_torch_batched`` with a random third of their indices marked
sparse and ``n_projs`` small enough that the cap binds.  Both sides
start from one state (the JAX batch carried across) and the port takes
the JAX draws, mirrored from the replicas' threefry keys as the dense
tests do: integer and bit state bitwise, totals within 1e-5 in log2
(PERF.md "Float bound").  End-of-sweep min snapshots decided by a float
tie are settled by ``test_torch_batched.min_ties``, reslice-if-better
decisions by ``test_torch_walks.reslice_ties``.
"""

from decimal import Decimal
import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from benchmarks.networks import lattice_2d
from tnco_tpu.app.cli import main as jmain
from tnco_tpu.ctree import ContractionTree
from tnco_tpu.kernels import pallas_walker as jpw
from tnco_tpu.kernels import sa_batched as jsb
from tnco_tpu.kernels import sa_finite as jsaf
from tnco_tpu.kernels import sa_finite_batched as jsfb
from tnco_tpu.kernels import sa_multiwalk as jsmw
from tnco_tpu.kernels import sa_walks as jsw
from tnco_tpu.kernels.sa_finite import SweepConfigFW
from tnco_tpu.kernels.sa_fullsweep import uniform_log2_dim
from tnco_tpu.kernels.sa_infinite import SweepConfig
from tnco_tpu.ops import bitops as jbit
from tnco_tpu.ops import costs as jcost
from tnco_tpu.optimize.finite_width import SimpleCostModel as JFWModel
from tnco_tpu.optimize.infinite_memory import SimpleCostModel as JIMModel
from tnco_tpu.parallel import replicas as jrep
from tnco_tpu.utils.tn import get_random_contraction_path
from tnco_tpu_torch.app import Optimizer, load_tn
from tnco_tpu_torch.app.cli import main as tmain
from tnco_tpu_torch.convert import (batch_from_numpy, batch_fw_from_numpy,
                                    batch_fw_to_numpy, batch_to_numpy)
from tnco_tpu_torch.ctree import ContractionTree as TContractionTree
from tnco_tpu_torch.kernels import sa_batched as tsb
from tnco_tpu_torch.kernels import sa_finite as tsaf
from tnco_tpu_torch.kernels import sa_finite_batched as tsfb
from tnco_tpu_torch.kernels import sa_multiwalk as tsmw
from tnco_tpu_torch.kernels import sa_walks as tsw
from tnco_tpu_torch.kernels import walker as tw
from tnco_tpu_torch.kernels.sa_finite import SweepConfigFW as TConfigFW
from tnco_tpu_torch.kernels.sa_infinite import SweepConfig as TConfig
from tnco_tpu_torch.ops import costs as tcost
from tnco_tpu_torch.optimize.finite_width import SimpleCostModel as TFWModel
from tnco_tpu_torch.optimize.infinite_memory import SimpleCostModel as TIMModel
from tnco_tpu_torch.parallel import replicas as trep
from test_torch_batched import (B, TOTAL_ATOL, Margins, compare, fields,
                                min_ties, network, sweep_draws)
from test_torch_batched_fw import fw_draws
from test_torch_exchange import sync_fw
from test_torch_stall import jax_jitter
from test_torch_walker import _jax_draws as walker_draws
from test_torch_walker_fw import _jax_draws as walker_fw_draws
from test_torch_walks import _jax_draws as walks_draws
from test_torch_walks import reslice_ties
from torch_reference_native import reference_native  # noqa: F401

MAX_WIDTH = {'lattice': 4.0, 'mixed': 6.0, 'hyper': 4.0}
# n_projs: the cap binds on the unions of a few sparse indices; 6 gives
# a cap that is not an integer.
N_PROJS = {'lattice': 4, 'mixed': 6, 'hyper': 4}


def _t(x):
    return torch.from_numpy(np.array(x, order='C'))


def _order(ts):
    return tuple(dict.fromkeys(x for xs in ts for x in xs))


def sparse_labels(ts, seed):
    """A random third of the network's indices (at least two)."""
    order = _order(ts)
    r = np.random.default_rng(seed)
    labels = [x for x in order if r.random() < 1 / 3]
    return labels if len(labels) >= 2 else list(order[:2])


def setup(kind, seed, b=B):
    """JAX and port trees of one network, the sparse labels, and the
    sparse engine inputs of both packages: ``(jax_trees, port_trees,
    labels, n_projs, jax_params, port_params)``; the params are
    ``(sparse_wb [W, 1], log2_n_projs)``."""
    ts, out, dims = network(kind, seed)
    order = _order(ts)
    labels = sparse_labels(ts, seed)
    jt, tt = [], []
    for r in range(b):
        (path,) = [p for p in get_random_contraction_path(
            ts, out, merge_paths=False, seed=seed + r) if p]
        kw = dict(output_inds=out, check_shared_inds=True, inds_order=order)
        jt.append(ContractionTree(path, ts, dims, **kw))
        tt.append(TContractionTree(path, ts, dims, **kw))
    n_projs = N_PROJS[kind]
    dev = JIMModel(sparse_inds=labels, n_projs=n_projs).device_params(order)
    lanes = dev['sparse_lanes']
    jp = (jnp.asarray(lanes)[:, None], dev['log2_n_projs'])
    tp = (_t(lanes.view(np.int32))[:, None], dev['log2_n_projs'])
    return jt, tt, labels, n_projs, jp, tp


def _log2d(jt):
    w = jt[0].inds_array.shape[1]
    return np.array(jbit.pad_log2_dims(jt[0].log2_dims_array, w))


def _ul_int(jt):
    ul = uniform_log2_dim(jt[0].log2_dims_array)
    return ul if ul is not None and float(ul).is_integer() else None


def test_cost_models_and_ccost(random_seed):
    """``device_params`` of both cost models, and ``ccost_log2`` with
    sparse lanes, equal the JAX package's bitwise."""
    seed = random_seed % 1000
    ts, _, _ = network('mixed', seed)
    order = _order(ts)
    labels = sparse_labels(ts, seed)
    for jm, tm in ((JIMModel(sparse_inds=labels, n_projs=6),
                    TIMModel(sparse_inds=labels, n_projs=6)),
                   (JFWModel(3.0, sparse_inds=labels, n_projs=1000),
                    TFWModel(3.0, sparse_inds=labels, n_projs=1000))):
        want, got = jm.device_params(order), tm.device_params(order)
        assert got['sparse_lanes'].dtype == np.uint32
        np.testing.assert_array_equal(got['sparse_lanes'],
                                      want['sparse_lanes'])
        assert got['log2_n_projs'].dtype == np.float32
        assert got['log2_n_projs'] == want['log2_n_projs']
    assert TIMModel().device_params(order) == {'sparse_lanes': None,
                                               'log2_n_projs': None}
    w = len(order) // 32 + 1
    lanes = np.random.default_rng(seed).integers(
        0, 2**32, (9, w), dtype=np.uint64).astype(np.uint32)
    log2d = np.log2(np.random.default_rng(seed).integers(2, 6, len(order)))
    jl, tl = jbit.pad_log2_dims(log2d, w), _t(jbit.pad_log2_dims(log2d, w))
    sp = TIMModel(sparse_inds=labels, n_projs=6).device_params(order)
    np.testing.assert_array_equal(
        tcost.ccost_log2(_t(lanes.view(np.int32)), tl,
                         sparse_lanes=_t(sp['sparse_lanes'].view(np.int32)),
                         log2_n_projs=sp['log2_n_projs']).numpy(),
        np.asarray(jcost.ccost_log2(jnp.asarray(lanes), jl,
                                    sparse_lanes=jnp.asarray(
                                        sp['sparse_lanes']),
                                    log2_n_projs=sp['log2_n_projs'])))


@pytest.mark.parametrize('kind', ['lattice', 'mixed'])
def test_widths_costs_and_slicers_match_jax(random_seed, kind):
    """The sparse widths, costs and slicers bitwise: ``init_batch(_fw)``,
    ``_width_b``, ``compute_lcc_fw``, ``compute_widths``, ``_lcc_fw_b``
    and ``_greedy_slices_b`` (with and without popcount widths), and the
    one-replica ``greedy_slices``."""
    seed = random_seed % 1000
    jt, tt, _, _, jp, tp = setup(kind, seed)
    log2d = _log2d(jt)
    w = log2d.size // 32
    lanes_np = np.asarray(jp[0][:, 0])
    seeds = [seed + r for r in range(B)]
    mw = MAX_WIDTH[kind]
    jb = jsfb.init_batch_fw(jt, seeds, mw, log2d, sparse_lanes=lanes_np,
                            log2_n_projs=jp[1])
    tb = tsfb.init_batch_fw(tt, seeds, mw, log2d, sparse_lanes=lanes_np,
                            log2_n_projs=tp[1], device='cpu')
    compare(jb, batch_fw_to_numpy(tb), 'init_batch_fw', skip=('keys',))
    assert np.asarray(jb.slices).any()
    jbi = jsb.init_batch(jt, seeds, log2d, sparse_lanes=lanes_np,
                         log2_n_projs=jp[1])
    tbi = tsb.init_batch(tt, seeds, log2d, sparse_lanes=lanes_np,
                         log2_n_projs=tp[1], device='cpu')
    compare(jbi, batch_to_numpy(tbi), 'init_batch', skip=())
    # The cap binds: some costs are below their dense values.
    dense = np.asarray(jsb.init_batch(jt, seeds, log2d).lcc)
    assert (np.asarray(jbi.lcc) < dense).any()

    log2d_w32 = log2d.reshape(w, 32)
    tlog2d = _t(log2d_w32)
    ul = uniform_log2_dim(jt[0].log2_dims_array)
    lanes = np.random.default_rng(seed).integers(
        0, 2**32, (w, 16), dtype=np.uint64).astype(np.uint32)
    for u in {None, ul}:
        np.testing.assert_array_equal(
            tsb._width_b(_t(lanes.view(np.int32)), tlog2d, sparse_wb=tp[0],
                         log2_n_projs=tp[1], uniform_log2=u).numpy(),
            np.asarray(jsb._width_b(jnp.asarray(lanes), log2d_w32,
                                    sparse_wb=jp[0], log2_n_projs=jp[1],
                                    uniform_log2=u)), err_msg=f'{u}')

    f = fields(jb)
    nodes = np.stack([f['c0'], f['c1'], f['par']], axis=1)       # [N, 3, B]
    for r in range(B):
        args_j = (jnp.asarray(nodes[..., r]), jnp.asarray(f['inds'][..., r]),
                  jnp.asarray(f['slices'][:, r]), jnp.asarray(log2d))
        args_t = (_t(nodes[..., r]), _t(f['inds'][..., r].view(np.int32)),
                  _t(f['slices'][:, r].view(np.int32)), _t(log2d))
        np.testing.assert_array_equal(
            tsaf.compute_lcc_fw(*args_t, tp[0][:, 0], tp[1]).numpy(),
            np.asarray(jsaf.compute_lcc_fw(*args_j, jp[0][:, 0], jp[1])))
        np.testing.assert_array_equal(
            tsaf.compute_widths(args_t[1], args_t[3], tp[0][:, 0],
                                tp[1]).numpy(),
            np.asarray(jsaf.compute_widths(args_j[1], args_j[3],
                                           jp[0][:, 0], jp[1])))

    tbf = batch_fw_from_numpy(f, 'cpu')
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    jitter = _t(np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (w * 32,), dtype=jnp.float32))(keys)).T)
    skip = jnp.zeros(w, jnp.uint32)
    for u in {None, _ul_int(jt)}:
        want = jsfb._lcc_fw_b(jb.c0, jb.c1, jb.inds, jb.slices, log2d_w32,
                              jp[0], jp[1], uniform_log2=u)
        got = tsfb._lcc_fw_b(tbf.c0, tbf.c1, tbf.inds, tbf.slices, tlog2d,
                             *tp, uniform_log2=u)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        want = jsfb._greedy_slices_b(jb.c0, jb.inds, jb.width, keys,
                                     jnp.float32(mw - 1), log2d_w32, skip,
                                     jp[0], jp[1], uniform_log2=u)
        got = tsfb._greedy_slices_b(tbf.c0, tbf.inds, tbf.width, jitter,
                                    mw - 1, tlog2d,
                                    torch.zeros(w, dtype=torch.int32), *tp,
                                    uniform_log2=u)
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want), err_msg=f'{u}')
        assert np.asarray(want).any()

    cfg = SweepConfigFW(n_leaves=jt[0].n_leaves, n_lanes=w)
    tcfg = TConfigFW(n_leaves=jt[0].n_leaves, n_lanes=w)
    for r in range(2):
        width = jsaf.compute_widths(jnp.asarray(f['inds'][..., r]),
                                    jnp.asarray(log2d), jp[0][:, 0], jp[1])
        want = jsaf.greedy_slices(jnp.asarray(nodes[..., r]),
                                  jnp.asarray(f['inds'][..., r]), width,
                                  keys[r], jnp.float32(mw - 1),
                                  jnp.asarray(log2d), skip, cfg,
                                  jp[0][:, 0], jp[1])
        got = tsaf.greedy_slices(
            _t(nodes[..., r]), _t(f['inds'][..., r].view(np.int32)),
            _t(np.asarray(width)), jitter[:, r], mw - 1, _t(log2d),
            torch.zeros(w, dtype=torch.int32), tcfg, tp[0][:, 0], tp[1])
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want), err_msg=f'{r}')


@pytest.mark.parametrize('kind,prob_kind', [('lattice', 'mh'),
                                            ('mixed', 'mh'),
                                            ('hyper', 'greedy')])
def test_sweep_im_matches_jax(monkeypatch, random_seed, kind, prob_kind):
    """One sparse lockstep IM sweep at a time, 5 sweeps, the JAX state
    fed back."""
    seed = random_seed % 1000
    jt, _, _, _, jp, tp = setup(kind, seed)
    log2d = _log2d(jt)
    w = log2d.size // 32
    batch = jsb.init_batch(jt, [seed + r for r in range(B)], log2d,
                           sparse_lanes=np.asarray(jp[0][:, 0]),
                           log2_n_projs=jp[1])
    flags = dict(n_leaves=jt[0].n_leaves, n_lanes=w, prob_kind=prob_kind)
    cfg, tcfg = SweepConfig(**flags), TConfig(**flags)
    ul = uniform_log2_dim(jt[0].log2_dims_array)
    applied = 0
    for i, beta in enumerate(np.linspace(0.5, 8.0, 5, dtype=np.float32)):
        margins = Margins(monkeypatch)
        dr = sweep_draws(batch.keys, cfg.n_leaves)
        ref, rm = jsb.run_sweeps_batched(batch, jnp.asarray([beta]),
                                         jnp.asarray(log2d.reshape(w, 32)),
                                         cfg, *jp, uniform_log2=ul)
        got, gm = tsb.run_sweeps_batched(
            batch_from_numpy(fields(batch), 'cpu'), [beta],
            _t(log2d.reshape(w, 32)), tcfg, *tp, uniform_log2=ul, draws=dr)
        g = batch_to_numpy(got)
        min_ties(batch, ref, g)
        what = f'{kind} {prob_kind} sweep {i}'
        compare(ref, g, what, margins)
        assert int(gm['moves'][0]) == int(rm['moves'][0]) > 0, what
        applied += int((np.asarray(ref.c0) != np.asarray(batch.c0)).sum())
        batch = ref
    assert applied > 0


@pytest.mark.parametrize('kind,mns', [('lattice', 0), ('lattice', 2),
                                      ('mixed', 0), ('hyper', 2)])
def test_sweep_fw_matches_jax(monkeypatch, random_seed, kind, mns):
    """One sparse lockstep FW sweep at a time, 6 sweeps (reslices after
    sweeps 0 and 3), with and without the rescue (whose whole-tree
    recost is sparse too)."""
    seed = random_seed % 1000
    jt, _, _, _, jp, tp = setup(kind, seed)
    log2d = _log2d(jt)
    w = log2d.size // 32
    mw = MAX_WIDTH[kind]
    batch = jsfb.init_batch_fw(jt, [seed + r for r in range(B)], mw, log2d,
                               sparse_lanes=np.asarray(jp[0][:, 0]),
                               log2_n_projs=jp[1])
    flags = dict(n_leaves=jt[0].n_leaves, n_lanes=w, max_new_slices=mns)
    cfg, tcfg = SweepConfigFW(**flags), TConfigFW(**flags)
    ul = _ul_int(jt)
    skip = np.zeros(w, dtype=np.uint32)
    args = (jnp.float32(mw), jnp.asarray(log2d.reshape(w, 32)),
            jnp.asarray(skip))
    targs = (mw, _t(log2d.reshape(w, 32)), _t(skip.view(np.int32)))
    for i, beta in enumerate(np.linspace(0.5, 8.0, 6, dtype=np.float32)):
        upd = i % 3 == 0
        margins = Margins(monkeypatch)
        dr, _ = fw_draws(batch, cfg)
        ref, rm = jsfb.run_sweeps_fw_batched(
            batch, jnp.asarray([beta]), jnp.asarray([upd]), *args, cfg, *jp,
            uniform_log2=ul)
        got, gm = tsfb.run_sweeps_fw_batched(
            batch_fw_from_numpy(fields(batch), 'cpu'), [beta], [upd],
            *targs, tcfg, *tp, uniform_log2=ul, draws=dr)
        g = batch_fw_to_numpy(got)
        min_ties(batch, ref, g)
        what = f'{kind} mns={mns} sweep {i}'
        compare(ref, g, what, margins)
        assert int(gm['moves'][0]) == int(rm['moves'][0]) > 0, what
        batch = ref
    assert np.asarray(batch.slices).any()


def _pos_t(pos):
    return torch.from_numpy(np.array(pos))


@pytest.mark.parametrize('kind', ['lattice', 'mixed'])
def test_multiwalk_matches_jax(random_seed, kind):
    """Sparse ``run_multiwalk`` and ``run_multiwalk_fw`` (a reslice on
    every other iteration), one iteration at a time over 4, the JAX
    state fed back."""
    seed = random_seed % 1000
    jt, _, _, _, jp, tp = setup(kind, seed)
    log2d = _log2d(jt)
    w = log2d.size // 32
    log2d_w32 = jnp.asarray(log2d.reshape(w, 32))
    tlog2d = _t(log2d_w32)
    ul = uniform_log2_dim(jt[0].log2_dims_array)
    p = 4
    seeds = [seed + r for r in range(B)]
    sp_np = np.asarray(jp[0][:, 0])
    cfg = SweepConfig(n_leaves=jt[0].n_leaves, n_lanes=w)
    batch = jsb.init_batch(jt, seeds, log2d, sparse_lanes=sp_np,
                           log2_n_projs=jp[1])
    pos = jnp.full((p, B), -1, jnp.int32)
    for it, beta in enumerate((0.5, 2.0, 6.0, 20.0)):
        draws = walker_draws(batch.keys, cfg, p)
        ref, mref = jsmw.run_multiwalk(batch, jnp.asarray([beta]), log2d_w32,
                                       cfg, p, pos, *jp, uniform_log2=ul)
        got, mgot = tsmw.run_multiwalk(
            batch_from_numpy(fields(batch), 'cpu'), [beta], tlog2d,
            TConfig(n_leaves=cfg.n_leaves, n_lanes=w), p, _pos_t(pos), *tp,
            uniform_log2=ul, draws=draws)
        what = f'IM {kind} iteration {it}'
        compare(ref, batch_to_numpy(got), what)
        np.testing.assert_array_equal(mgot['pos'].numpy(),
                                      np.asarray(mref['pos']), err_msg=what)
        assert int(mgot['applied']) == int(mref['applied']), what
        batch, pos = ref, mref['pos']

    mw = MAX_WIDTH[kind]
    cfg = SweepConfigFW(n_leaves=jt[0].n_leaves, n_lanes=w)
    tcfg = TConfigFW(n_leaves=jt[0].n_leaves, n_lanes=w)
    batch = jsfb.init_batch_fw(jt, seeds, mw, log2d, sparse_lanes=sp_np,
                               log2_n_projs=jp[1])
    skip = jnp.zeros(w, jnp.uint32)
    pos = jnp.full((p, B), -1, jnp.int32)
    for it, beta in enumerate((0.5, 2.0, 6.0, 20.0)):
        mask = [it % 2 == 0]
        draws = walker_fw_draws(batch.keys, cfg, p, mask[0])
        start = batch
        ref, mref = jsmw.run_multiwalk_fw(
            batch, jnp.asarray([beta]), jnp.asarray(mask), mw, log2d_w32,
            skip, cfg, p, pos, *jp, uniform_log2=ul)
        got, mgot = tsmw.run_multiwalk_fw(
            batch_fw_from_numpy(fields(batch), 'cpu'), [beta], mask, mw,
            tlog2d, torch.zeros(w, dtype=torch.int32), tcfg, p, _pos_t(pos),
            *tp, uniform_log2=ul, draws=draws)
        what = f'FW {kind} iteration {it}'
        g = batch_fw_to_numpy(got)
        reslice_ties(start, ref, g, log2d_w32, ul, cfg.n_leaves, *jp)
        compare(ref, g, what)
        np.testing.assert_array_equal(mgot['pos'].numpy(),
                                      np.asarray(mref['pos']), err_msg=what)
        batch, pos = ref, mref['pos']


@pytest.mark.parametrize('kind', ['lattice', 'mixed'])
def test_walks_fw_matches_jax(random_seed, kind):
    """Sparse ``run_walks_fw`` one iteration at a time over 5 (reslices
    at 0, 2 and 4): 'auto' takes the reference slicer, as the JAX engine
    does for sparse indices."""
    seed = random_seed % 1000
    jt, _, _, _, jp, tp = setup(kind, seed)
    log2d = _log2d(jt)
    w = log2d.size // 32
    log2d_w32 = jnp.asarray(log2d.reshape(w, 32))
    ul = uniform_log2_dim(jt[0].log2_dims_array)
    mw = MAX_WIDTH[kind]
    batch = jsfb.init_batch_fw(jt, [seed + r for r in range(B)], mw, log2d,
                               sparse_lanes=np.asarray(jp[0][:, 0]),
                               log2_n_projs=jp[1])
    cfg = SweepConfigFW(n_leaves=jt[0].n_leaves, n_lanes=w)
    tcfg = TConfigFW(n_leaves=jt[0].n_leaves, n_lanes=w)
    skip = jnp.zeros(w, jnp.uint32)
    pos = jnp.full((8, B), -1, jnp.int32)
    applied = 0
    for it, beta in enumerate((0.5, 2.0, 8.0, 1.0, 30.0)):
        reslice = it % 2 == 0
        draws = {k: v[None] for k, v in walks_draws(batch.keys, cfg).items()}
        ref, mref = jsw.run_walks_fw(
            batch, jnp.asarray([beta], jnp.float32), jnp.asarray([reslice]),
            jnp.float32(mw), log2d_w32, skip, cfg, pos, *jp,
            uniform_log2=ul)
        got, mgot = tsw.run_walks_fw(
            batch_fw_from_numpy(fields(batch), 'cpu'), [beta], [reslice], mw,
            _t(log2d_w32), torch.zeros(w, dtype=torch.int32), tcfg,
            _pos_t(pos), *tp, uniform_log2=ul, draws=draws, device='cpu')
        what = f'{kind} iteration {it}'
        g = batch_fw_to_numpy(got)
        reslice_ties(batch, ref, g, log2d_w32, ul, cfg.n_leaves, *jp)
        compare(ref, g, what)
        assert int(mgot['applied']) == int(mref['applied']), what
        np.testing.assert_array_equal(mgot['pos'].numpy(),
                                      np.asarray(mref['pos']), err_msg=what)
        applied += int(mref['applied'])
        batch, pos = ref, mref['pos']
    assert applied > 0


def test_walks_slicer_rule_and_walker_refusal(random_seed):
    """Sparse indices take the reference slicer ('plane' raises, in both
    packages); the walker refuses them with the JAX walker's words."""
    seed = random_seed % 1000
    jt, tt, labels, n_projs, jp, tp = setup('lattice', seed)
    log2d = _log2d(jt)
    w = log2d.size // 32
    assert tsw._union_planes(None, 1.0, w) == w
    assert tsw._union_planes(None, 1.0, w, sparse=True) == 0
    assert tsw._union_planes('ref', 1.0, w, sparse=True) == 0
    mw = MAX_WIDTH['lattice']
    seeds = list(range(B))
    jb = jsfb.init_batch_fw(jt, seeds, mw, log2d)
    tb = batch_fw_from_numpy(fields(jb), 'cpu')
    cfg = SweepConfigFW(n_leaves=jt[0].n_leaves, n_lanes=w)
    tcfg = TConfigFW(n_leaves=jt[0].n_leaves, n_lanes=w)
    pos = jnp.full((4, B), -1, jnp.int32)
    with pytest.raises(ValueError, match='no sparse indices') as je:
        jsw.run_walks_fw(jb, jnp.ones(1), jnp.ones(1, bool), mw,
                         jnp.asarray(log2d.reshape(w, 32)),
                         jnp.zeros(w, jnp.uint32), cfg, pos, *jp,
                         uniform_log2=1.0, slicer='plane')
    with pytest.raises(ValueError) as te:
        tsw.run_walks_fw(tb, [1.0], [True], mw, _t(log2d.reshape(w, 32)),
                         torch.zeros(w, dtype=torch.int32), tcfg,
                         _pos_t(pos), *tp, uniform_log2=1.0, slicer='plane',
                         generator=torch.Generator(), device='cpu')
    assert str(te.value) == str(je.value)

    msg = 'walker engine: dense cost model only'
    jbi = jsb.init_batch(jt, seeds, log2d)
    with pytest.raises(NotImplementedError, match=msg):
        jpw.run_walker(jbi, jnp.ones(1), jnp.asarray(log2d.reshape(w, 32)),
                       SweepConfig(n_leaves=cfg.n_leaves, n_lanes=w), 4, pos,
                       *jp, interpret=True)
    with pytest.raises(NotImplementedError, match=msg):
        tw.run_walker(batch_from_numpy(fields(jbi), 'cpu'), [1.0],
                      _t(log2d.reshape(w, 32)),
                      TConfig(n_leaves=cfg.n_leaves, n_lanes=w), 4,
                      _pos_t(pos), *tp, generator=torch.Generator())
    with pytest.raises(NotImplementedError, match=msg):
        tw.run_walker_fw(tb, [1.0], [True], mw, _t(log2d.reshape(w, 32)),
                         torch.zeros(w, dtype=torch.int32), tcfg, 4,
                         _pos_t(pos), *tp, generator=torch.Generator())
    for cls, cm in ((trep.ReplicaRunner,
                     TIMModel(sparse_inds=labels, n_projs=n_projs)),
                    (trep.ReplicaRunnerFW,
                     TFWModel(mw, sparse_inds=labels, n_projs=n_projs))):
        with pytest.raises(NotImplementedError, match=msg):
            cls(tt, seeds, cmodel=cm, engine='walker', device='cpu')


def _jax_engine(monkeypatch, ctrees, fw, accel, **kw):
    """The JAX runner's engine with its native engine off; the port's is
    pinned off too (the native cases: tests/test_torch_native.py)."""
    from tnco_tpu import native
    monkeypatch.setattr(jrep, '_accel_available', lambda: accel)
    monkeypatch.setattr(native, 'available', lambda: False)
    monkeypatch.setattr(trep, '_native_available', lambda: False)
    cls = jrep.ReplicaRunnerFW if fw else jrep.ReplicaRunner
    return cls(ctrees, list(range(len(ctrees))), **kw).engine


@pytest.mark.parametrize('fw', [False, True])
def test_auto_engine_rule_with_sparse(monkeypatch, fw):
    """``resolve_engine`` against the JAX runners' 'auto' rule with and
    without sparse indices, new slices and another accept rule; the
    port's runners on a network past 32768 words take the rule's engine
    ('vmapped' for a sparse one, on the card too)."""
    for accel in (False, True):
        for n, sparse, mns, pk in ((10, True, 0, None), (3000, True, 0, None),
                                   (3000, False, 0, None),
                                   (3000, False, 2, None),
                                   (3000, False, 0, 'greedy'),
                                   (10, False, 2, None)):
            if mns and not fw:             # no new slices in IM
                continue
            want = trep.resolve_engine(
                n, 20, accel=accel, native=False, sparse=sparse,
                max_new_slices=mns, disable_shared_inds=False, prob_kind=pk,
                fw=fw)
            big = n * 20 > 32768
            if not fw:
                exp = ('batched' if not big else
                       'walker' if accel and not sparse and pk is None
                       else 'vmapped')
            else:
                exp = ('batched' if not big and not mns else
                       'walks' if accel and not sparse and not mns and
                       pk is None else 'vmapped')
            assert want == exp, (accel, n, sparse, mns, pk)

    ts, out, dims = lattice_2d(26, 26)
    path = get_random_contraction_path(ts, out, seed=0)
    order = _order(ts)
    labels = [x for x in order if x in out] or list(order[:3])
    kw = dict(output_inds=out, inds_order=order)
    jt = [ContractionTree(path, ts, dims, **kw)]
    tt = [TContractionTree(path, ts, dims, **kw)]
    assert len(tt[0]) * tt[0].inds_array.shape[1] > 32768
    for accel in (False, True):
        cm_j = (JFWModel(40.0, sparse_inds=labels, n_projs=8) if fw else
                JIMModel(sparse_inds=labels, n_projs=8))
        cm_t = (TFWModel(40.0, sparse_inds=labels, n_projs=8) if fw else
                TIMModel(sparse_inds=labels, n_projs=8))
        want = _jax_engine(monkeypatch, jt, fw, accel, cmodel=cm_j)
        monkeypatch.setattr(trep, '_accel_available', lambda device: accel)
        cls = trep.ReplicaRunnerFW if fw else trep.ReplicaRunner
        assert want == 'vmapped'
        assert cls(tt, [0], cmodel=cm_t, device='cpu').engine == want


@pytest.mark.parametrize('slicer', ['host', 'device'])
def test_kick_matches_jax(random_seed, slicer):
    """The slice-kick under a sparse cost model, host and device slicer:
    every field as the JAX kick's (totals within 1e-5 on the device)."""
    seed = random_seed % 1000
    jt, tt, labels, n_projs, _, _ = setup('lattice', seed, b=8)
    mw = MAX_WIDTH['lattice']
    seeds = [seed + r for r in range(8)]
    jr = jrep.ReplicaRunnerFW(jt, seeds, cmodel=JFWModel(
        mw, sparse_inds=labels, n_projs=n_projs), engine='walks', n_walks=4)
    tr = trep.ReplicaRunnerFW(tt, seeds, cmodel=TFWModel(
        mw, sparse_inds=labels, n_projs=n_projs), engine='walks', n_walks=4,
        device='cpu')
    jr.run(np.linspace(0, 8, 6).astype(np.float32), chunk_size=3,
           update_slices=3)
    sync_fw(jr, tr)
    victims, src, kseed = [5, 2, 6], 1, 11 + seed
    jrep.kick_lanes_fw(jr, victims, src, seed=kseed, slicer=slicer)
    jitter = (jax_jitter(kseed, sorted(victims), tr.log2d_w32.numel())
              if slicer == 'device' else None)
    trep.kick_lanes_fw(tr, victims, src, seed=kseed, slicer=slicer,
                       jitter=jitter)
    want, got = fields(jr.states), batch_fw_to_numpy(tr.states)
    for k, v in want.items():
        if k == 'keys':
            continue
        if k in ('log2_total', 'min_log2_total') and slicer == 'device':
            np.testing.assert_allclose(got[k], v, rtol=0, atol=TOTAL_ATOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


SPARSE_MAP = '\n'.join([
    '2 a b', '2 b c', '2 c d', '2 d e', '2 e f', '2 f g', '2 g a',
    '2 b e', '2 c g', '2 a * /', '2 c * /', '2 e * /', '2 g * /',
    '2 d *'])


def _audit(tn, res, n_projs, max_width=None):
    """Each result's path is a valid tree whose exact sparse cost (the
    cost model's ``contraction_cost`` over the tree, with its slices)
    is the reported cost (the finite-width model with no cap and no
    slices is the infinite-memory one); widths (sparse part capped) fit
    the cap."""
    from tnco_tpu_torch.ctree import ContractionTree as TCT
    cap = float('inf') if max_width is None else max_width
    cm = TFWModel(cap, sparse_inds=tn.sparse_inds, n_projs=n_projs)
    dense = TFWModel(float('inf'))
    for r in res:
        tree = TCT(r.path, tn.ts_inds, tn.dims, output_inds=tn.output_inds)
        assert tree.is_valid()
        slices = getattr(r, 'slices', frozenset())
        costs = [sum(m.contraction_cost(tree.inds[n.children[0]],
                                        tree.inds[n.children[1]],
                                        tree.inds[p], tree.dims, slices)
                     for p, n in enumerate(tree.nodes) if not n.is_leaf())
                 for m in (cm, dense)]
        assert Decimal(costs[0]) == r.cost
        assert costs[0] < costs[1]                 # the cap binds
        if max_width is not None:
            for xs in tree.inds:
                assert cm.width(frozenset(xs) - slices,
                                tree.dims) <= max_width + 1e-9


@pytest.mark.parametrize('max_width', [None, 2.0])
def test_optimizer_sparse_index_map(random_seed, max_width):
    """``Optimizer`` IM and FW on an index map with ``/`` rows ('auto'
    takes 'batched' here), every result audited by the sparse exact
    cost."""
    tn = load_tn(SPARSE_MAP, fuse=0)
    assert len(tn.sparse_inds) == 4
    kw = {} if max_width is None else {'max_width': max_width}
    _, res = Optimizer(seed=random_seed, device='cpu', **kw).optimize(
        tn, betas=(0, 10), n_steps=20, n_runs=4, n_projs=4, fuse=0)
    _audit(tn, res, 4, max_width)
    _, res = Optimizer(seed=random_seed, device='cpu', engine='vmapped',
                       **kw).optimize(tn, betas=(0, 10), n_steps=20,
                                      n_runs=4, n_projs=4, fuse=0)
    _audit(tn, res, 4, max_width)


def test_cli_optimize_n_projs(capsys):
    """The CLI's ``optimize --n-projs`` on the README chain with a
    sparse output row: the best cost equals the JAX CLI's."""
    chain = ('[(2, "a", "b"), (2, "b", "c"), (2, "c", "d"), '
             '(4, "d", "*", "/"), (4, "a", "*", "/")]')
    argv = ['optimize', chain, '--betas=(0, 100)', '--n-steps=50',
            '--n-runs=2', '--seed=3', '--fuse=False', '--n-projs=2']
    assert tmain(argv + ['--device', 'cpu']) == 0
    got = json.loads(capsys.readouterr().out)
    assert jmain(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert got['tn'] == want['tn']
    assert [r['cost'] for r in got['res']] == [r['cost'] for r in want['res']]
    dense = 4 * 4 * 2 + 4 * 2 * 2 + 4 * 2 * 4     # a chain order, no cap
    assert int(Decimal(got['res'][0]['cost'])) < dense
    assert math.isfinite(float(got['res'][0]['cost']))

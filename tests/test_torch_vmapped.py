"""The port's 'vmapped' engines (``kernels/sa_infinite.py``,
``kernels/sa_finite.py``: replica-major states over the lockstep sweep)
and the runners' 'vmapped' engine vs the JAX package's.

Each comparison starts both sides from one state (the JAX vmapped state
carried across) and feeds the port the JAX draws, mirrored from the
replicas' threefry keys as ``test_torch_batched`` and
``test_torch_batched_fw`` do (the vmapped sweep splits its key as the
lockstep one does): integer and bit state bitwise, totals within 1e-5
in log2 (PERF.md "Float bound"), min snapshots decided by a float tie
settled by ``test_torch_batched.min_ties``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tnco_tpu.kernels import sa_batched as jsb
from tnco_tpu.kernels import sa_finite as jsaf
from tnco_tpu.kernels import sa_finite_batched as jsfb
from tnco_tpu.kernels import sa_infinite as jsa
from tnco_tpu.kernels.sa_finite import SweepConfigFW
from tnco_tpu.kernels.sa_infinite import SweepConfig
from tnco_tpu.parallel import replicas as jrep
from tnco_tpu_torch.convert import batch_from_numpy, batch_fw_from_numpy
from tnco_tpu_torch.kernels import sa_batched as tsb
from tnco_tpu_torch.kernels import sa_finite as tsaf
from tnco_tpu_torch.kernels import sa_infinite as tsa
from tnco_tpu_torch.kernels.sa_finite import SweepConfigFW as TConfigFW
from tnco_tpu_torch.kernels.sa_infinite import SweepConfig as TConfig
from tnco_tpu_torch.optimize.finite_width import SimpleCostModel as TFWModel
from tnco_tpu_torch.optimize.infinite_memory import SimpleCostModel as TIMModel
from tnco_tpu_torch.parallel import replicas as trep
from test_torch_batched import (B, TOTAL_ATOL, Margins, compare, fields,
                                min_ties, sweep_draws)
from test_torch_batched_fw import fw_draws
from test_torch_sparse import MAX_WIDTH, _log2d, _t, _ul_int, setup
from torch_reference_native import reference_native  # noqa: F401

_IM = ('nodes', 'inds', 'hyper', 'lcc', 'log2_total', 'min_log2_total',
       'min_nodes', 'min_inds', 'key')


def jax_batch(states):
    """A JAX vmapped state (stacked pytree) as the JAX lane-major batch
    (the inverse of ``replicas._to_vmapped(_fw)``), for the shared
    comparison helpers."""
    nodes, mnodes = states.nodes, states.min_nodes

    def lanes(x):
        return jnp.moveaxis(x, 0, -1)

    im = (nodes[..., 0].T, nodes[..., 1].T, nodes[..., 2].T,
          lanes(states.inds), lanes(states.hyper), states.lcc.T)
    mins = (mnodes[..., 0].T, mnodes[..., 1].T, mnodes[..., 2].T,
            lanes(states.min_inds))
    if isinstance(states, jsaf.SAStateFW):
        return jsfb.SABatchFW(*im, states.width.T, states.slices.T,
                              states.log2_total, states.min_log2_total,
                              *mins, states.min_slices.T, states.key)
    return jsb.SABatch(*im, states.log2_total, states.min_log2_total, *mins,
                       states.key)


def port_fields(states):
    """A port state as numpy fields in the JAX lane-major layout."""
    from tnco_tpu_torch.convert import batch_fw_to_numpy, batch_to_numpy
    if isinstance(states, tsaf.SAStateFW):
        return batch_fw_to_numpy(tsaf.to_batch_fw(states))
    return batch_to_numpy(tsa.to_batch(states))


def port_states(jstates):
    """The JAX vmapped state carried across to the port (CPU)."""
    b = jax_batch(jstates)
    if isinstance(jstates, jsaf.SAStateFW):
        return tsaf.from_batch_fw(batch_fw_from_numpy(fields(b), 'cpu'))
    return tsa.from_batch(batch_from_numpy(fields(b), 'cpu'))


def _sparse(jp, tp, sparse):
    if not sparse:
        return (None, None), (None, None)
    return (jp[0][:, 0], jp[1]), (tp[0][:, 0], tp[1])


@pytest.mark.parametrize('kind,sparse', [('lattice', False),
                                         ('mixed', True)])
def test_init_state_matches_jax(random_seed, kind, sparse):
    """``init_state`` and ``init_state_fw`` (the slicer's jitter the JAX
    one draws from ``split(PRNGKey(seed))[1]``) field by field; the
    codecs invert each other and equal the JAX runners'."""
    seed = random_seed % 1000
    jt, tt, _, _, jp, tp = setup(kind, seed, b=2)
    (jsl, jcap), (tsl, tcap) = _sparse(jp, tp, sparse)
    log2d = _log2d(jt)
    n_bits = log2d.size
    mw = MAX_WIDTH[kind]
    for r in range(2):
        want = jsa.init_state(jt[r], seed + r, jnp.asarray(log2d),
                              sparse_lanes=jsl, log2_n_projs=jcap)
        got = tsa.init_state(tt[r], seed + r, _t(log2d), sparse_lanes=tsl,
                             log2_n_projs=tcap, device='cpu')
        for k in _IM:
            w, g = np.asarray(getattr(want, k)), getattr(got, k).numpy()
            if k in ('log2_total', 'min_log2_total'):
                np.testing.assert_allclose(g, w, rtol=0, atol=TOTAL_ATOL)
            else:
                np.testing.assert_array_equal(g.view(w.dtype), w, k)
        want = jsaf.init_state_fw(jt[r], seed + r, mw, jnp.asarray(log2d),
                                  sparse_lanes=jsl, log2_n_projs=jcap)
        k_slice = jax.random.split(jax.random.PRNGKey(seed + r))[1]
        jitter = _t(jax.random.uniform(k_slice, (n_bits,),
                                       dtype=jnp.float32))
        got = tsaf.init_state_fw(tt[r], seed + r, mw, _t(log2d),
                                 sparse_lanes=tsl, log2_n_projs=tcap,
                                 jitter=jitter, device='cpu')
        assert np.asarray(want.slices).any()
        for k in tsaf.SAStateFW.field_names():
            if k == 'key':
                continue
            w, g = np.asarray(getattr(want, k)), getattr(got, k).numpy()
            if k in ('log2_total', 'min_log2_total'):
                np.testing.assert_allclose(g, w, rtol=0, atol=TOTAL_ATOL)
            else:
                np.testing.assert_array_equal(g.view(w.dtype), w, k)
    seeds = [seed, seed + 1]
    jb = jsb.init_batch(jt, seeds, log2d)
    tb = batch_from_numpy(fields(jb), 'cpu')
    states = tsa.from_batch(tb)
    for k in _IM:
        np.testing.assert_array_equal(
            getattr(states, k).numpy().view(np.uint32)
            if k in ('inds', 'hyper', 'min_inds', 'key') else
            getattr(states, k).numpy(),
            np.asarray(getattr(jrep._to_vmapped(jb), k)), err_msg=k)
    compare(jb, port_fields(states), 'codec', skip=())
    jbf = jsfb.init_batch_fw(jt, seeds, mw, log2d)
    tbf = tsaf.from_batch_fw(batch_fw_from_numpy(fields(jbf), 'cpu'))
    compare(jbf, port_fields(tbf), 'codec fw', skip=())
    np.testing.assert_array_equal(
        tbf.slices.numpy().view(np.uint32),
        np.asarray(jrep._to_vmapped_fw(jbf).slices))


@pytest.mark.parametrize('kind,sparse', [('lattice', False),
                                         ('mixed', False),
                                         ('lattice', True),
                                         ('hyper', True)])
def test_run_sweeps_batch_matches_jax(monkeypatch, random_seed, kind,
                                      sparse):
    """``run_sweeps_batch`` one sweep at a time, 5 sweeps, against the
    JAX vmapped ``run_sweeps_batch``; per-replica moves bitwise."""
    seed = random_seed % 1000
    jt, _, _, _, jp, tp = setup(kind, seed)
    (jsl, jcap), (tsl, tcap) = _sparse(jp, tp, sparse)
    log2d = _log2d(jt)
    w = log2d.size // 32
    cfg = SweepConfig(n_leaves=jt[0].n_leaves, n_lanes=w)
    tcfg = TConfig(n_leaves=jt[0].n_leaves, n_lanes=w)
    states = jrep._to_vmapped(jsb.init_batch(
        jt, [seed + r for r in range(B)], log2d,
        sparse_lanes=None if jsl is None else np.asarray(jsl),
        log2_n_projs=jcap))
    for i, beta in enumerate(np.linspace(0.5, 8.0, 5, dtype=np.float32)):
        margins = Margins(monkeypatch)
        dr = sweep_draws(states.key, cfg.n_leaves)
        ref, rm = jsa.run_sweeps_batch(states, jnp.asarray([beta]),
                                       jnp.asarray(log2d), cfg, jsl, jcap)
        got, gm = tsa.run_sweeps_batch(port_states(states), [beta],
                                       _t(log2d), tcfg, tsl, tcap, draws=dr)
        g = port_fields(got)
        what = f'{kind} sparse={sparse} sweep {i}'
        min_ties(jax_batch(states), jax_batch(ref), g)
        compare(jax_batch(ref), g, what, margins)
        np.testing.assert_array_equal(gm['moves'].numpy(),
                                      np.asarray(rm['moves']), err_msg=what)
        assert gm['moves'].shape == (B, 1) and int(gm['moves'].sum()) > 0
        np.testing.assert_allclose(gm['log2_min_total'].numpy(),
                                   np.asarray(rm['log2_min_total']), rtol=0,
                                   atol=TOTAL_ATOL)
        states = ref


@pytest.mark.parametrize('kind,sparse,mns', [('lattice', False, 0),
                                             ('mixed', False, 2),
                                             ('lattice', True, 0),
                                             ('hyper', True, 2)])
def test_run_sweeps_fw_batch_matches_jax(monkeypatch, random_seed, kind,
                                         sparse, mns):
    """``run_sweeps_fw_batch`` one sweep at a time, 6 sweeps (reslices
    after sweeps 0 and 3), with and without the rescue, against the JAX
    vmapped ``run_sweeps_fw_batch``."""
    seed = random_seed % 1000
    jt, _, _, _, jp, tp = setup(kind, seed)
    (jsl, jcap), (tsl, tcap) = _sparse(jp, tp, sparse)
    log2d = _log2d(jt)
    w = log2d.size // 32
    mw = MAX_WIDTH[kind]
    flags = dict(n_leaves=jt[0].n_leaves, n_lanes=w, max_new_slices=mns)
    cfg, tcfg = SweepConfigFW(**flags), TConfigFW(**flags)
    states = jrep._to_vmapped_fw(jsfb.init_batch_fw(
        jt, [seed + r for r in range(B)], mw, log2d,
        sparse_lanes=None if jsl is None else np.asarray(jsl),
        log2_n_projs=jcap))
    skip = np.zeros(w, dtype=np.uint32)
    for i, beta in enumerate(np.linspace(0.5, 8.0, 6, dtype=np.float32)):
        upd = i % 3 == 0
        margins = Margins(monkeypatch)
        dr, _ = fw_draws(jax_batch(states), cfg)
        ref, rm = jsaf.run_sweeps_fw_batch(
            states, jnp.asarray([beta]), jnp.asarray([upd]),
            jnp.float32(mw), jnp.asarray(log2d), jnp.asarray(skip), cfg,
            jsl, jcap)
        got, gm = tsaf.run_sweeps_fw_batch(
            port_states(states), [beta], [upd], mw, _t(log2d),
            _t(skip.view(np.int32)), tcfg, tsl, tcap, draws=dr)
        g = port_fields(got)
        what = f'{kind} sparse={sparse} mns={mns} sweep {i}'
        min_ties(jax_batch(states), jax_batch(ref), g)
        compare(jax_batch(ref), g, what, margins)
        np.testing.assert_array_equal(gm['moves'].numpy(),
                                      np.asarray(rm['moves']), err_msg=what)
        states = ref
    assert np.asarray(states.slices).any()


def test_single_replica_calls_and_state_to_ctree(random_seed):
    """``sweep``/``run_sweeps`` and ``sweep_fw``/``run_sweeps_fw`` of one
    replica equal that replica's row of the batch call;
    ``state_to_ctree`` equals the JAX function's."""
    seed = random_seed % 1000
    jt, tt, _, _, _, tp = setup('lattice', seed)
    log2d = _log2d(jt)
    w = log2d.size // 32
    tcfg = TConfig(n_leaves=jt[0].n_leaves, n_lanes=w)
    states = tsa.stack([tsa.init_state(t, seed + r, _t(log2d),
                                       sparse_lanes=tp[0][:, 0],
                                       log2_n_projs=tp[1], device='cpu')
                        for r, t in enumerate(tt)])
    gen = torch.Generator().manual_seed(seed)
    dr = tsb.draw_sweep(gen, tcfg.n_leaves, B)
    dr = {k: v[None] for k, v in dr.items()}
    full, fm = tsa.run_sweeps_batch(states, [2.0], _t(log2d), tcfg,
                                    tp[0][:, 0], tp[1], draws=dr)
    for r in range(B):
        one = {k: v[..., r:r + 1] for k, v in dr.items()}
        got, moves = tsa.sweep(tsa.unstack(states, r), 2.0, _t(log2d), tcfg,
                               tp[0][:, 0], tp[1], draws=one)
        for k in _IM:
            assert torch.equal(getattr(got, k),
                               getattr(tsa.unstack(full, r), k)), k
        assert int(moves) == int(fm['moves'][r, 0])
        got, hist = tsa.run_sweeps(tsa.unstack(states, r), [2.0], _t(log2d),
                                   tcfg, tp[0][:, 0], tp[1], draws=one)
        assert hist['moves'].shape == (1,)
        want = jsa.state_to_ctree(jt[r], np.asarray(
            got.nodes), np.asarray(got.inds.numpy().view(np.uint32)))
        tree = tsa.state_to_ctree(tt[r], got.nodes, got.inds)
        np.testing.assert_array_equal(tree.nodes_array, want.nodes_array)
        np.testing.assert_array_equal(tree.inds_array, want.inds_array)
        assert tree.is_valid(check_shared_inds=True)

    mw = MAX_WIDTH['lattice']
    fcfg = TConfigFW(n_leaves=jt[0].n_leaves, n_lanes=w, max_new_slices=1)
    states = tsa.stack([tsaf.init_state_fw(t, seed + r, mw, _t(log2d),
                                           device='cpu')
                        for r, t in enumerate(tt)])
    skip = torch.zeros(w, dtype=torch.int32)
    gen = torch.Generator().manual_seed(seed)
    full, fm = tsaf.run_sweeps_fw_batch(states, [2.0], [True], mw, _t(log2d),
                                        skip, fcfg, generator=gen)
    for r in range(B):
        gen = torch.Generator().manual_seed(seed)
        got, moves = tsaf.sweep_fw(tsa.unstack(states, r), 2.0, True, mw,
                                   _t(log2d), skip, fcfg, generator=gen)
        assert tree_ok(tt[r], got)
    assert fm['moves'].shape == (B, 1) and int(fm['moves'].sum()) > 0


def tree_ok(template, state):
    return tsa.state_to_ctree(template, state.nodes, state.inds).is_valid(
        check_shared_inds=True)


def _runners(fw, engine, seed, sparse, mns=0):
    _, tt, labels, n_projs, _, _ = setup('lattice', seed)
    kw = dict(sparse_inds=labels, n_projs=n_projs) if sparse else {}
    seeds = [seed + r for r in range(B)]
    if fw:
        return trep.ReplicaRunnerFW(
            tt, seeds, cmodel=TFWModel(MAX_WIDTH['lattice'], **kw),
            engine=engine, max_number_new_slices=mns, device='cpu'), tt
    return trep.ReplicaRunner(tt, seeds, cmodel=TIMModel(**kw) if kw else
                              None, engine=engine, device='cpu'), tt


@pytest.mark.parametrize('fw,sparse,mns', [(False, False, 0),
                                           (False, True, 0),
                                           (True, False, 0),
                                           (True, True, 2)])
def test_vmapped_runner_equals_batched(random_seed, fw, sparse, mns):
    """A 'vmapped' runner equals a 'batched' runner bitwise on the same
    seeds: min totals, best and current trees, slices and counts."""
    seed = random_seed % 1000
    betas = np.linspace(0, 6, 7)
    outs = []
    for engine in ('batched', 'vmapped'):
        runner, _ = _runners(fw, engine, seed, sparse, mns)
        kw = {'update_slices': 3} if fw else {}
        info = runner.run(betas, chunk_size=3, **kw)
        outs.append((runner, info))
    (rb, ib), (rv, iv) = outs
    assert rv.engine == 'vmapped' and isinstance(
        rv.states, tsaf.SAStateFW if fw else tsa.SAStateIM)
    np.testing.assert_array_equal(rv.log2_min_totals(), rb.log2_min_totals())
    assert iv['moves'] == ib['moves'] > 0 and iv['applied'] is None
    if not fw:
        assert rv.best() == rb.best()
    for r in range(B):
        for name in ('min_ctree', 'ctree'):
            a, b = getattr(rv, name)(r), getattr(rb, name)(r)
            np.testing.assert_array_equal(a.nodes_array, b.nodes_array)
            np.testing.assert_array_equal(a.inds_array, b.inds_array)
            assert a.is_valid(check_shared_inds=True)
        if fw:
            np.testing.assert_array_equal(rv.min_slices_lanes(r),
                                          rb.min_slices_lanes(r))
            np.testing.assert_array_equal(rv.slices_lanes(r),
                                          rb.slices_lanes(r))


def test_vmapped_refuses_exchange_and_kick_and_keeps_device_rule(
        random_seed, monkeypatch):
    """Exchange and the kick are lane-major only (as in the JAX runners):
    'vmapped' warns and ignores ``exchange_every`` and refuses the kick.
    The device rule holds."""
    seed = random_seed % 1000
    for fw in (False, True):
        runner, tt = _runners(fw, 'vmapped', seed, False)
        plain, _ = _runners(fw, 'vmapped', seed, False)
        with pytest.warns(UserWarning, match='exchange_every'):
            runner.run(np.linspace(0, 4, 4), chunk_size=1, exchange_every=1)
        plain.run(np.linspace(0, 4, 4), chunk_size=1)
        np.testing.assert_array_equal(runner.log2_min_totals(),
                                      plain.log2_min_totals())
    with pytest.raises(ValueError, match='lane-major'):
        trep.kick_lanes_fw(runner, [1], 0, seed=1)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trep.ReplicaRunner(tt, [0] * B, engine='vmapped')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsa.init_state(tt[0], 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsaf.init_state_fw(tt[0], 0, 3.0)


@pytest.mark.cuda
def test_card_vmapped_matches_cpu(random_seed):
    """The card against the CPU from one state with the same draws: a
    sparse 'vmapped' IM sweep and an FW sweep with a reslice and the
    rescue; integer and bit state bitwise, totals within 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    seed = random_seed % 1000
    jt, _, _, _, jp, tp = setup('lattice', seed)
    log2d = _log2d(jt)
    w = log2d.size // 32
    ul = _ul_int(jt)
    cfg = SweepConfigFW(n_leaves=jt[0].n_leaves, n_lanes=w, max_new_slices=2)
    tcfg = TConfigFW(n_leaves=jt[0].n_leaves, n_lanes=w, max_new_slices=2)
    jstates = jrep._to_vmapped_fw(jsfb.init_batch_fw(
        jt, [seed + r for r in range(B)], MAX_WIDTH['lattice'], log2d,
        sparse_lanes=np.asarray(jp[0][:, 0]), log2_n_projs=jp[1]))
    dr, _ = fw_draws(jax_batch(jstates), cfg)
    im_dr = {k: dr[k] for k in ('leaf', 'rand_bit', 'u')}
    outs = []
    for dev in ('cpu', 'cuda'):
        st = port_states(jstates)
        st = tsaf.SAStateFW(**{k: getattr(st, k).to(dev)
                               for k in tsaf.SAStateFW.field_names()})
        d = {k: v.to(dev) for k, v in dr.items()}
        got, _ = tsaf.run_sweeps_fw_batch(
            st, [2.0], [True], MAX_WIDTH['lattice'], _t(log2d).to(dev),
            torch.zeros(w, dtype=torch.int32, device=dev), tcfg,
            tp[0][:, 0].to(dev), tp[1], uniform_log2=ul, draws=d)
        im = tsa.SAStateIM(*(getattr(st, k) for k in _IM))
        got_im, _ = tsa.run_sweeps_batch(
            im, [2.0], _t(log2d).to(dev),
            TConfig(n_leaves=cfg.n_leaves, n_lanes=w), tp[0][:, 0].to(dev),
            tp[1], uniform_log2=ul,
            draws={k: v.to(dev) for k, v in im_dr.items()})
        outs.append((port_fields(got), port_fields(got_im)))
    for a, b in zip(*outs):
        for k, v in a.items():
            if k in ('log2_total', 'min_log2_total'):
                np.testing.assert_allclose(b[k], v, rtol=0, atol=TOTAL_ATOL,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(b[k], v, err_msg=k)

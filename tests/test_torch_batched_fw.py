"""The port's finite-width lockstep engine (``run_sweeps_fw_batched``),
its rescue helpers and the 'batched' runners vs the JAX package.

Each sweep starts both sides from one state (the JAX ``SABatchFW``
carried across) and feeds the port the JAX draws, mirrored from the
replicas' threefry keys: a 2-way split for the leaf, a 5-way split per
walk step (the bit, the uniform, the rescue's priorities and its second
uniform), and after the walk, from the key the replica reached, a 2-way
split whose second key draws the reslice jitter.  One sweep is compared
at a time, over 8 sweeps with the JAX state fed back: trees, index words,
hyper, lcc, pre-slicing widths, slices, the min state and ``moves``
bitwise; totals within 1e-5 in log2 (PERF.md "Float bound").  End-of-
sweep min snapshots decided by a tie within that bound are settled by
``test_torch_batched.min_ties``; decisions under the bound would be
legitimate disagreements, and the assertions name the smallest margins.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tnco_tpu.kernels import sa_finite as jsaf
from tnco_tpu.kernels import sa_finite_batched as jsfb
from tnco_tpu.kernels.sa_finite import SweepConfigFW
from tnco_tpu.kernels.sa_fullsweep import uniform_log2_dim
from tnco_tpu.ops import bitops as jbit
from tnco_tpu_torch.convert import batch_fw_from_numpy, batch_fw_to_numpy
from tnco_tpu_torch.kernels import sa_finite as tsaf
from tnco_tpu_torch.kernels import sa_finite_batched as tsfb
from tnco_tpu_torch.kernels.sa_batched import max_walk_steps
from tnco_tpu_torch.kernels.sa_finite import SweepConfigFW as TConfigFW
from test_torch_batched import (B, TOTAL_ATOL, Margins, _t, compare,
                                      fields, min_ties, network, trees)
from torch_reference_native import reference_native  # noqa: F401

MAX_WIDTH = {'lattice': 4.0, 'mixed': 6.0, 'hyper': 4.0}


def _setup(kind, seed, prob_kind='mh', dsi=False, mns=0, skip=False):
    ts, out, dims = network(kind, seed)
    ctrees = trees(ts, out, dims, seed)
    t = ctrees[0]
    w = t.inds_array.shape[1]
    log2d = np.array(jbit.pad_log2_dims(t.log2_dims_array, w))
    skip_lanes = np.zeros(w, dtype=np.uint32)
    if skip:                       # never slice a few of the indices
        skip_lanes[0] = np.uint32(0x00F0F00F)
    batch = jsfb.init_batch_fw(ctrees, [seed + r for r in range(B)],
                               MAX_WIDTH[kind], log2d, skip_lanes=skip_lanes)
    flags = dict(n_leaves=t.n_leaves, n_lanes=w, prob_kind=prob_kind,
                 disable_shared_inds=dsi, max_new_slices=mns)
    ul = uniform_log2_dim(t.log2_dims_array)
    if ul is not None and not float(ul).is_integer():
        ul = None                  # the JAX runner's gate (replicas.py:915)
    return (batch, SweepConfigFW(**flags), TConfigFW(**flags),
            log2d.reshape(w, 32), ul, skip_lanes)


_split2 = jax.vmap(lambda k: tuple(jax.random.split(k)))
_unif = jax.vmap(lambda k: jax.random.uniform(k, dtype=jnp.float32))


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _mirror_fw(keys, n_leaves, n_steps, n_bits):
    """``_sweep_fw_batched``'s walk draws (``sa_finite_batched.py:526-527,
    566,585,609,649`` and ``sa_finite.py:344``) for every step a replica
    may take, and the key before each step."""
    keys, k_leaf = _split2(keys)
    leaf = jax.vmap(lambda k: jax.random.randint(k, (), 0, n_leaves))(k_leaf)

    def step(keys, _):
        nxt, k_pick, k_u, k_sl, k_u2 = jax.vmap(
            lambda k: tuple(jax.random.split(k, 5)))(keys)
        prio = jax.vmap(lambda k: jax.random.uniform(
            k, (n_bits,), dtype=jnp.float32))(k_sl).T
        return nxt, (keys, jax.vmap(jax.random.bernoulli)(k_pick),
                     _unif(k_u), prio, _unif(k_u2))

    last, (seen, rand_bit, u, prio, u2) = jax.lax.scan(step, keys, None,
                                                       length=n_steps)
    return leaf, rand_bit, u, prio, u2, jnp.concatenate([seen, last[None]])


def _walk_steps(par, leaf):
    """Steps each replica's walk takes: its start node's ancestors below
    the root (no move changes them)."""
    out = []
    for r, lf in enumerate(leaf):
        pos, n = par[lf, r], 0
        while pos != -1 and par[pos, r] != -1:
            pos, n = par[pos, r], n + 1
        out.append(n)
    return np.asarray(out)


def fw_draws(batch, cfg):
    """One sweep's draws in the port's layout (leading sweep axis 1),
    and the keys the JAX sweep ends with."""
    n_bits = cfg.n_lanes * 32
    leaf, rand_bit, u, prio, u2, seen = _mirror_fw(
        batch.keys, cfg.n_leaves, max_walk_steps(cfg.n_leaves), n_bits)
    steps = _walk_steps(np.asarray(batch.par), np.asarray(leaf))
    end = jnp.asarray(np.asarray(seen)[steps, np.arange(B)])
    keys_out, k_res = _split2(end)
    jitter = jax.vmap(lambda k: jax.random.uniform(
        k, (n_bits,), dtype=jnp.float32))(k_res).T
    dr = {'leaf': leaf, 'rand_bit': rand_bit, 'u': u, 'jitter': jitter}
    if cfg.max_new_slices:
        dr.update(prio=prio, u2=u2)
    return {k: _t(v)[None] for k, v in dr.items()}, np.asarray(keys_out)


CASES = [
    # kind, prob_kind, disable_shared_inds, max_new_slices, skip, reslice
    ('lattice', 'mh', False, 0, False, True),
    ('lattice', 'greedy', False, 0, False, False),
    ('lattice', 'mh', True, 2, False, True),
    ('mixed', 'mh', False, 0, True, True),
    ('mixed', 'mh', False, 2, False, False),
    ('mixed', 'base', False, 2, True, True),
    ('hyper', 'mh', False, 0, False, True),
    ('hyper', 'mh', False, 2, True, True),
]


@pytest.mark.parametrize('kind,prob_kind,dsi,mns,skip,reslice', CASES)
def test_sweep_fw_matches_jax(monkeypatch, random_seed, kind, prob_kind, dsi,
                              mns, skip, reslice):
    """One ``_sweep_fw_batched`` at a time, 8 sweeps (reslices after
    sweeps 0, 3 and 6 where on), the JAX state fed back."""
    seed = random_seed % 1000
    batch, cfg, tcfg, log2d_w32, ul, skip_lanes = _setup(
        kind, seed, prob_kind, dsi, mns, skip)
    args = (jnp.asarray(MAX_WIDTH[kind], jnp.float32),
            jnp.asarray(log2d_w32), jnp.asarray(skip_lanes))
    targs = (MAX_WIDTH[kind], _t(log2d_w32), _t(skip_lanes.view(np.int32)))
    betas = np.linspace(0.5, 8.0, 8, dtype=np.float32)
    changed = {'walk': 0, 'reslice': 0}
    for i, beta in enumerate(betas):
        upd = reslice and i % 3 == 0
        margins = Margins(monkeypatch)
        dr, keys_out = fw_draws(batch, cfg)
        ref, rm = jsfb.run_sweeps_fw_batched(
            batch, jnp.asarray([beta]), jnp.asarray([upd]), *args, cfg,
            uniform_log2=ul)
        np.testing.assert_array_equal(keys_out, np.asarray(ref.keys))
        got, gm = tsfb.run_sweeps_fw_batched(
            batch_fw_from_numpy(fields(batch), 'cpu'), [beta], [upd],
            *targs, tcfg, uniform_log2=ul, draws=dr)
        what = f'{kind} {prob_kind} mns={mns} sweep {i}'
        g = batch_fw_to_numpy(got)
        min_ties(batch, ref, g)
        compare(ref, g, what, margins)
        assert int(gm['moves'][0]) == int(rm['moves'][0]) > 0, what
        moved = not np.array_equal(np.asarray(ref.slices),
                                   np.asarray(batch.slices))
        changed['reslice' if upd else 'walk'] += moved
        batch = ref
    if mns:                     # the rescue added slices during a walk
        assert changed['walk'] > 0, changed
    assert np.asarray(batch.slices).any()


def test_run_fw_histories(random_seed):
    """``run_sweeps_fw_batched`` over a chunk of 4 sweeps with a reslice
    mask: histories, moves, slices and ``hyper`` against ``_run_fw``."""
    seed = random_seed % 1000
    batch, cfg, tcfg, log2d_w32, ul, skip_lanes = _setup('mixed', seed)
    betas = np.linspace(1.0, 6.0, 4, dtype=np.float32)
    mask = np.asarray([True, False, True, False])
    args = (jnp.asarray(6.0, jnp.float32), jnp.asarray(log2d_w32),
            jnp.asarray(skip_lanes))
    per, b = [], batch
    for beta, upd in zip(betas, mask):
        per.append(fw_draws(b, cfg)[0])
        b, _ = jsfb.run_sweeps_fw_batched(b, jnp.asarray([beta]),
                                          jnp.asarray([upd]), *args, cfg,
                                          uniform_log2=ul)
    dr = {k: torch.cat([d[k] for d in per]) for k in per[0]}
    ref, rm = jsfb.run_sweeps_fw_batched(batch, jnp.asarray(betas),
                                         jnp.asarray(mask), *args, cfg,
                                         uniform_log2=ul)
    tb = batch_fw_from_numpy(fields(batch), 'cpu')
    got, gm = tsfb.run_sweeps_fw_batched(
        tb, betas, mask, 6.0, _t(log2d_w32), _t(skip_lanes.view(np.int32)),
        tcfg, uniform_log2=ul, draws=dr)
    compare(ref, batch_fw_to_numpy(got), 'chunk')
    np.testing.assert_array_equal(gm['moves'].numpy(), np.asarray(rm['moves']))
    for k in ('log2_total', 'log2_min_total'):
        np.testing.assert_allclose(gm[k].numpy(), np.asarray(rm[k]), rtol=0,
                                   atol=TOTAL_ATOL, err_msg=k)
    compare(batch, batch_fw_to_numpy(tb), 'input', skip=())


@pytest.mark.parametrize('kind', ['lattice', 'mixed'])
def test_rescue_helpers_match_jax(random_seed, kind):
    """``compute_lcc_fw`` and ``_pick_rescue_slices`` per replica against
    the JAX functions, on the batch's trees and random candidate sets,
    start widths around the cap and caps of 1 to 4 picks."""
    seed = random_seed % 1000
    batch, cfg, _, log2d_w32, _, _ = _setup(kind, seed)
    log2d = jnp.asarray(log2d_w32).reshape(-1)
    tlog2d = _t(log2d)
    w, n_bits = cfg.n_lanes, cfg.n_lanes * 32
    rng = np.random.default_rng(seed)
    nodes = np.stack([np.asarray(batch.c0), np.asarray(batch.c1),
                      np.asarray(batch.par)], axis=1)            # [N, 3, B]
    inds = np.asarray(batch.inds)
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    cand = rng.integers(0, 2**32, (w, B), dtype=np.uint64).astype(
        np.uint32) & np.asarray(batch.inds)[-1]
    cand[:, 0] = 0                                           # no candidate
    start = (MAX_WIDTH[kind] + rng.uniform(-1, 6, B)).astype(np.float32)
    prio = np.stack([np.asarray(jax.random.uniform(
        keys[r], (n_bits,), dtype=jnp.float32)) for r in range(B)], axis=1)
    mw = jnp.asarray(MAX_WIDTH[kind], jnp.float32)
    for k in (1, 2, 4):
        got = tsaf._pick_rescue_slices(
            _t(prio), _t(cand.view(np.int32)), k, _t(start),
            torch.tensor(MAX_WIDTH[kind]), tlog2d, w).numpy().view(np.uint32)
        for r in range(B):
            want = jsaf._pick_rescue_slices(keys[r], jnp.asarray(cand[:, r]),
                                            k, start[r], mw, log2d, w)
            np.testing.assert_array_equal(got[:, r], np.asarray(want),
                                          err_msg=f'k={k} replica {r}')
    for r in range(B):
        sl = np.asarray(batch.slices)[:, r]
        want = jsaf.compute_lcc_fw(jnp.asarray(nodes[..., r]),
                                   jnp.asarray(inds[..., r]),
                                   jnp.asarray(sl), log2d)
        got = tsaf.compute_lcc_fw(_t(nodes[..., r]),
                                  _t(inds[..., r].view(np.int32)),
                                  _t(sl.view(np.int32)), tlog2d)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generator_and_malformed_draws(random_seed):
    """Generator draws are reproducible and the rescue runs from them;
    malformed ``draws=`` raise."""
    seed = random_seed % 1000
    batch, cfg, tcfg, log2d_w32, ul, skip_lanes = _setup('lattice', seed,
                                                         mns=2)
    targs = (4.0, _t(log2d_w32), _t(skip_lanes.view(np.int32)), tcfg)
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(3)
        got, gm = tsfb.run_sweeps_fw_batched(
            batch_fw_from_numpy(fields(batch), 'cpu'), [1.0, 2.0, 3.0],
            [True, False, True], *targs, uniform_log2=ul, generator=gen)
        outs.append(batch_fw_to_numpy(got))
        assert int(gm['moves'].sum()) > 0
    for k in outs[0]:
        np.testing.assert_array_equal(outs[1][k], outs[0][k], err_msg=k)
    d = tsfb.draw_sweep_fw(torch.Generator().manual_seed(1), cfg.n_leaves, B,
                           cfg.n_lanes * 32, True, True)
    assert d['jitter'].shape == (cfg.n_lanes * 32, B)
    assert d['u2'].shape == d['u'].shape
    good, _ = fw_draws(batch, cfg)
    tb = batch_fw_from_numpy(fields(batch), 'cpu')
    for dr in ({k: v for k, v in good.items() if k != 'prio'},
               dict(good, jitter=good['jitter'][:, :-1]),
               dict(good, u2=good['u2'].double().int())):
        with pytest.raises(ValueError, match='draws'):
            tsfb.run_sweeps_fw_batched(tb, [1.0], [True], *targs,
                                       uniform_log2=ul, draws=dr)
    with pytest.raises(ValueError, match='generator'):
        tsfb.run_sweeps_fw_batched(tb, [1.0], [True], *targs,
                                   uniform_log2=ul)
    with pytest.raises(ValueError, match='one entry per sweep'):
        tsfb.run_sweeps_fw_batched(tb, [1.0, 2.0], [True], *targs,
                                   uniform_log2=ul, draws=good)


@pytest.mark.cuda
def test_card_sweep_fw_matches_cpu(random_seed):
    """The card against the CPU on one chunk of 3 FW sweeps (a reslice
    and the rescue) from one state and the same draws."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    seed = random_seed % 1000
    batch, cfg, tcfg, log2d_w32, ul, skip_lanes = _setup('lattice', seed,
                                                         mns=2)
    per, b = [], batch
    args = (jnp.asarray(4.0, jnp.float32), jnp.asarray(log2d_w32),
            jnp.asarray(skip_lanes))
    for beta in (1.0, 2.0, 3.0):
        per.append(fw_draws(b, cfg)[0])
        b, _ = jsfb.run_sweeps_fw_batched(b, jnp.asarray([beta]),
                                          jnp.asarray([True]), *args, cfg,
                                          uniform_log2=ul)
    dr = {k: torch.cat([d[k] for d in per]) for k in per[0]}
    outs = []
    for dev in ('cpu', 'cuda'):
        got, _ = tsfb.run_sweeps_fw_batched(
            batch_fw_from_numpy(fields(batch), dev), [1.0, 2.0, 3.0],
            [True] * 3, 4.0, _t(log2d_w32).to(dev),
            _t(skip_lanes.view(np.int32)).to(dev), tcfg, uniform_log2=ul,
            draws={k: v.to(dev) for k, v in dr.items()})
        outs.append(batch_fw_to_numpy(got))
    for k, v in outs[0].items():
        if k in ('log2_total', 'min_log2_total'):
            np.testing.assert_allclose(outs[1][k], v, rtol=0,
                                       atol=TOTAL_ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(outs[1][k], v, err_msg=k)


def _audit_fw(runner, max_width):
    """Best trees valid, widths within the cap after the min slices, the
    exact sliced total equal to the device min total."""
    log2d = runner.template.log2_dims_array
    mins = runner.log2_min_totals()
    for r in range(runner.n_replicas):
        best = runner.min_ctree(r)
        assert best.is_valid(check_shared_inds=True)
        sl = np.unpackbits(runner.min_slices_lanes(r).view(np.uint8),
                           bitorder='little')[:len(log2d)].astype(bool)
        bits = np.unpackbits(best.inds_array.view(np.uint8), axis=1,
                             bitorder='little')[:, :len(log2d)].astype(bool)
        assert ((bits & ~sl) @ log2d).max() <= max_width + 1e-9
        nodes = best.nodes_array
        total = sum(2.0 ** float(((bits[nodes[i, 0]] | bits[nodes[i, 1]]) |
                                  sl) @ log2d)
                    for i in range(len(nodes)) if nodes[i, 0] >= 0)
        assert abs(np.log2(total) - mins[r]) < 1e-4


@pytest.mark.parametrize('kind,mns', [('lattice', 0), ('lattice', 2),
                                      ('mixed', 2)])
def test_runner_fw_batched(random_seed, kind, mns):
    """``ReplicaRunnerFW(engine='batched')`` on the CPU, with and without
    the rescue, audited; 'auto' picks it on a small network (without new
    slices, the JAX rule)."""
    from tnco_tpu_torch.ctree import ContractionTree as TContractionTree
    from tnco_tpu_torch.optimize.finite_width import SimpleCostModel
    from tnco_tpu_torch.parallel import ReplicaRunnerFW
    from tnco_tpu_torch.utils.tn import get_random_contraction_path
    ts, out, dims = network(kind, random_seed % 1000)
    order = tuple(dict.fromkeys(x for xs in ts for x in xs))
    ctrees = []
    for i in range(4):
        (path,) = [p for p in get_random_contraction_path(
            ts, out, merge_paths=False, seed=random_seed + i) if p]
        ctrees.append(TContractionTree(path, ts, dims, output_inds=out,
                                       check_shared_inds=True,
                                       inds_order=order))
    seeds = [random_seed + i for i in range(4)]
    cm = SimpleCostModel(max_width=MAX_WIDTH[kind])
    if not mns:
        assert ReplicaRunnerFW(ctrees, seeds, cmodel=cm,
                               device='cpu').engine == 'batched'
    runner = ReplicaRunnerFW(ctrees, seeds, cmodel=cm, engine='batched',
                             max_number_new_slices=mns, device='cpu')
    info = runner.run(np.linspace(0, 6, 7), update_slices=3, chunk_size=3)
    assert runner.sweeps_done == 9 and info['applied'] is None
    assert info['moves'] > 0
    _audit_fw(runner, MAX_WIDTH[kind])
    for r in range(4):
        assert runner.ctree(r).is_valid(check_shared_inds=True)


def test_runner_fw_rescue_rules(monkeypatch):
    """New slices not with the walk engines and 'sweep'; 'auto' with new
    slices keeps the JAX rule ('native' where the library runs, else
    'vmapped'); the device rule."""
    from tnco_tpu_torch.ctree import ContractionTree as TContractionTree
    from tnco_tpu_torch.optimize.finite_width import SimpleCostModel
    from tnco_tpu_torch.parallel import ReplicaRunnerFW
    from tnco_tpu_torch.utils.tn import get_random_contraction_path
    from benchmarks.networks import lattice_2d
    ts, out, dims = lattice_2d(3, 4)
    ctrees = [TContractionTree(get_random_contraction_path(ts, out, seed=0),
                               ts, dims, output_inds=out)]
    kw = dict(cmodel=SimpleCostModel(max_width=3), device='cpu')
    for engine in ('walks', 'multiwalk'):
        with pytest.raises(ValueError, match='max_number_new_slices'):
            ReplicaRunnerFW(ctrees, [1], engine=engine,
                            max_number_new_slices=2, **kw)
    from tnco_tpu_torch.parallel import replicas as trep
    runner = ReplicaRunnerFW(ctrees, [1], max_number_new_slices=2, **kw)
    assert runner.engine == 'native' and runner.cfg.max_new_slices == 2
    monkeypatch.setattr(trep, '_native_available', lambda: False)
    runner = ReplicaRunnerFW(ctrees, [1], max_number_new_slices=2, **kw)
    assert runner.engine == 'vmapped' and runner.cfg.max_new_slices == 2
    # 'native' takes the rescue, as in the JAX runner.
    nat = ReplicaRunnerFW(ctrees, [1], engine='native',
                          max_number_new_slices=2, **kw)
    assert nat.engine == 'native' and nat.cfg.max_new_slices == 2
    with pytest.raises(ValueError, match='max_number_new_slices'):
        ReplicaRunnerFW(ctrees, [1], engine='sweep', max_number_new_slices=2,
                        **kw)
    assert ReplicaRunnerFW(ctrees, [1], engine='sweep', **kw).engine == \
        'sweep'
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ReplicaRunnerFW(ctrees, [1], cmodel=SimpleCostModel(max_width=3),
                        engine='batched')


def test_optimizer_fw_default_fuse(random_seed):
    """``Optimizer(max_width=…)`` end to end on the CPU with the default
    ``fuse``: 'auto' runs 'batched'; every result is a valid path at its
    exact sliced cost, its widths within the cap after its slices."""
    from decimal import Decimal
    from test_torch_batched import _lattice_tn
    from tnco_tpu_torch.app import Optimizer, load_tn
    from tnco_tpu_torch.app.finite_width import sa as fw_sa
    from tnco_tpu_torch.app.finite_width.sa import _exact_component_cost
    from tnco_tpu_torch.ctree import ContractionTree as TContractionTree
    from tnco_tpu_torch.optimize.finite_width import SimpleCostModel
    tn = _lattice_tn(6, 6)
    runners = []
    cls = fw_sa.ReplicaRunnerFW

    class Recorded(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            runners.append(self)

    fw_sa.ReplicaRunnerFW = Recorded
    try:
        loaded, res = Optimizer(max_width=5, seed=random_seed,
                           device='cpu').optimize(tn, betas=(0, 4),
                                                  n_steps=6, n_runs=3,
                                                  update_slices=2)
    finally:
        fw_sa.ReplicaRunnerFW = cls
    (runner,) = runners
    assert runner.engine == 'batched'
    _audit_fw(runner, 5.0)
    assert 2 < loaded.n_tensors < load_tn(tn, fuse=0).n_tensors
    cm = SimpleCostModel(max_width=5)
    assert len(res) == 3 and res == sorted(res)
    for r in res:
        ctree = TContractionTree(r.path, loaded.ts_inds, loaded.dims,
                                 output_inds=loaded.output_inds)
        assert ctree.is_valid(check_shared_inds=True)
        exact = _exact_component_cost(ctree, cm, r.slices)
        assert r.cost == Decimal(0) + Decimal(exact)
        order = ctree.inds_order
        sl = np.zeros(len(order), dtype=bool)
        sl[[order.index(x) for x in r.slices]] = True
        bits = np.unpackbits(ctree.inds_array.view(np.uint8), axis=1,
                             bitorder='little')[:, :len(order)].astype(bool)
        assert ((bits & ~sl) @ ctree.log2_dims_array).max() <= 5 + 1e-9

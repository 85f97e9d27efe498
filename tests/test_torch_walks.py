"""The port's walks engine vs ``tnco_tpu.kernels.sa_walks.run_walks_fw``.

Each comparison starts both sides from one state (the JAX batch carried
across with :mod:`tnco_tpu_torch.convert`) and feeds the port the JAX
draws (``sa_multiwalk._draws(keys, nl, P, f32, 5)`` and the reslice
jitter of its fifth key) through ``draws=``.  One iteration is compared
at a time, for several iterations in turn, with and without a reslice:
positions, counters, trees, index words, slices and the min state
bitwise; ``lcc``/``width`` bitwise (exact integers on dim-2 networks);
totals within 1e-5 in log2 (the exp2/log2 gap between XLA and torch is
<= 1 ulp).  Per-walk proposals, accept and keep masks are compared on the
engines' internals.  A walk whose Metropolis margin is under the float
bound would be a legitimate disagreement; the assertions name such walks
instead of loosening anything.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from benchmarks.networks import lattice_2d
from tnco_tpu.ctree import ContractionTree
from tnco_tpu.kernels import sa_finite_batched as jsfb
from tnco_tpu.kernels import sa_multiwalk as jsmw
from tnco_tpu.kernels import sa_walks as jsw
from tnco_tpu.kernels.sa_finite import SweepConfigFW
from tnco_tpu.kernels.sa_fullsweep import uniform_log2_dim
from tnco_tpu.ops import bitops as jbit
from tnco_tpu.ops import costs as jcosts
from tnco_tpu.testing.utils import generate_random_tensors
from tnco_tpu.utils.tn import get_random_contraction_path
from tnco_tpu_torch.convert import batch_fw_from_numpy, batch_fw_to_numpy
from tnco_tpu_torch.kernels import sa_finite_batched as tsfb
from tnco_tpu_torch.kernels import sa_walks as tsw
from tnco_tpu_torch.kernels.sa_finite import SweepConfigFW as TConfigFW
from torch_reference_native import reference_native  # noqa: F401

TOTAL_ATOL = 1e-5
B, P = 4, 8
_TOTALS = ('log2_total', 'min_log2_total')


def _setup(net, seed):
    if net == 'lattice':
        ts, out, dims = lattice_2d(5, 5)
        max_width = 4.0
    elif net == 'mixed':           # dims 2 and 3: the reference slicer
        ts, out, dims = generate_random_tensors(
            seed, n_tensors=24, min_dim=2, max_dim=3, n_extra_edges=14,
            use_mixed_labels=False)
        assert len(set(dims.values())) == 2
        max_width = 7.0
    else:
        ts, out, dims = generate_random_tensors(
            seed, n_tensors=24, min_dim=2, max_dim=2, n_extra_edges=14,
            use_mixed_labels=False)
        max_width = 5.0
    ctrees = [ContractionTree(get_random_contraction_path(
        ts, out, seed=seed + i), ts, dims, output_inds=out)
        for i in range(B)]
    c = ctrees[0]
    w = c.inds_array.shape[1]
    log2d = jbit.pad_log2_dims(c.log2_dims_array, w)
    batch = jsfb.init_batch_fw(ctrees, [seed + i for i in range(B)],
                               max_width, np.asarray(log2d))
    cfg = SweepConfigFW(n_leaves=c.n_leaves, n_lanes=w)
    ul = uniform_log2_dim(c.log2_dims_array)
    return batch, cfg, log2d.reshape(w, 32), max_width, ul


def _jax_draws(keys, cfg):
    """The JAX engine's draws of one iteration, in the port's layout."""
    _, leaf, rand_bit, u, (k_res,) = jsmw._draws(keys, cfg.n_leaves, P,
                                                 jnp.float32, 5)
    jitter = jax.vmap(lambda k: jax.random.uniform(
        k, (cfg.n_lanes * 32,), dtype=jnp.float32))(k_res).T

    def t(x):
        return torch.from_numpy(np.array(x, order='C'))

    return {'leaf': t(np.asarray(leaf).T), 'rand_bit': t(np.asarray(
        rand_bit).T), 'u': t(np.asarray(u).T), 'jitter': t(jitter)}


def _fields(batch):
    return {k: np.asarray(getattr(batch, k)) for k in batch.__slots__}


def _assert_same(ref, got, what):
    g = got if isinstance(got, dict) else batch_fw_to_numpy(got)
    for k, v in _fields(ref).items():
        if k == 'keys':
            continue
        if k in _TOTALS:
            np.testing.assert_allclose(g[k], v, rtol=0, atol=TOTAL_ATOL,
                                       err_msg=f'{what}: {k}')
        else:
            np.testing.assert_array_equal(g[k], v, err_msg=f'{what}: {k}')


@pytest.mark.parametrize('net', ['lattice', 'random'])
def test_one_iteration_matches_jax(random_seed, net):
    batch, cfg, log2d_w32, max_width, ul = _setup(net, random_seed % 1000)
    assert ul == 1.0
    w = cfg.n_lanes
    tcfg = TConfigFW(n_leaves=cfg.n_leaves, n_lanes=w)
    skip = jnp.zeros(w, jnp.uint32)
    pos = jnp.full((P, B), -1, jnp.int32)
    schedule = [(0.5, True), (2.0, False), (8.0, True), (1.0, True),
                (30.0, False), (3.0, True)]
    applied = 0
    for it, (beta, reslice) in enumerate(schedule):
        draws = {k: v[None] for k, v in _jax_draws(batch.keys, cfg).items()}
        start = batch_fw_from_numpy(_fields(batch), 'cpu')
        pos_t = torch.from_numpy(np.asarray(pos).copy())
        ref, mref = jsw.run_walks_fw(
            batch, jnp.asarray([beta], jnp.float32), jnp.asarray([reslice]),
            jnp.float32(max_width), log2d_w32, skip, cfg, pos,
            uniform_log2=ul)
        got, mgot = tsw.run_walks_fw(
            start, [beta], [reslice], max_width,
            torch.from_numpy(np.array(log2d_w32)),
            torch.zeros(w, dtype=torch.int32), tcfg, pos_t,
            uniform_log2=ul, draws=draws, device='cpu')
        what = f'iteration {it} (beta={beta}, reslice={reslice})'
        _assert_same(ref, got, what)
        assert mgot['moves'] == int(mref['moves']) == B * P
        assert int(mgot['applied']) == int(mref['applied']), what
        np.testing.assert_array_equal(mgot['pos'].numpy(),
                                      np.asarray(mref['pos']), err_msg=what)
        applied += int(mref['applied'])
        batch, pos = ref, mref['pos']
    assert applied > 0


def _iterations(net, seed, schedule, slicer):
    """Both engines, one iteration at a time from the JAX state, the port
    on the JAX draws, with ``slicer``; yields ``(it, ref, got, mref,
    mgot)``."""
    batch, cfg, log2d_w32, max_width, ul = _setup(net, seed)
    w = cfg.n_lanes
    tcfg = TConfigFW(n_leaves=cfg.n_leaves, n_lanes=w)
    skip = jnp.zeros(w, jnp.uint32)
    pos = jnp.full((P, B), -1, jnp.int32)
    for it, (beta, reslice) in enumerate(schedule):
        draws = {k: v[None] for k, v in _jax_draws(batch.keys, cfg).items()}
        start = batch_fw_from_numpy(_fields(batch), 'cpu')
        pos_t = torch.from_numpy(np.asarray(pos).copy())
        ref, mref = jsw.run_walks_fw(
            batch, jnp.asarray([beta], jnp.float32), jnp.asarray([reslice]),
            jnp.float32(max_width), log2d_w32, skip, cfg, pos,
            uniform_log2=ul, slicer=slicer)
        got, mgot = tsw.run_walks_fw(
            start, [beta], [reslice], max_width,
            torch.from_numpy(np.array(log2d_w32)),
            torch.zeros(w, dtype=torch.int32), tcfg, pos_t,
            uniform_log2=ul, slicer=slicer, draws=draws, device='cpu')
        yield it, batch, ref, got, mref, mgot
        batch, pos = ref, mref['pos']


def reslice_ties(start, ref, got, log2d_w32, ul, n_leaves, sparse_wb=None,
                 log2_n_projs=None):
    """Settles reslice-if-better decisions made by a float tie.

    A replica's reslice keeps its slices and incrementally kept ``lcc``
    or takes the fresh slice set and its recomputed ``lcc``, whichever
    total is lower; where the two totals tie within the float bound
    (each side's own exp2/log2), the JAX engine and the port may decide
    differently.  For a replica whose tree matches but whose slices or
    ``lcc`` differ, each side's pair must be one of the two outcomes
    (slices as at the start, or ``lcc`` equal to the JAX ``_lcc_fw_b`` of
    the tree and those slices) and the outcomes' totals must tie; the
    port's fields are then set to the JAX result, so that the caller
    checks every other field bitwise.  ``sparse_wb``, ``log2_n_projs``:
    the JAX sparse engine inputs, if any.  Returns the replicas
    settled."""
    r, g, s0 = _fields(ref), got, _fields(start)

    def fresh(slices):
        return np.asarray(jsfb._lcc_fw_b(
            jnp.asarray(r['c0']), jnp.asarray(r['c1']),
            jnp.asarray(r['inds']), jnp.asarray(slices), log2d_w32,
            sparse_wb, log2_n_projs, uniform_log2=ul))

    sides = {'jax': (r, fresh(r['slices'])), 'port': (g, fresh(g['slices']))}
    settled = []
    for i in range(r['c0'].shape[1]):
        if (np.array_equal(g['slices'][:, i], r['slices'][:, i]) and
                np.array_equal(g['lcc'][:, i], r['lcc'][:, i])):
            continue
        for k in ('c0', 'c1', 'par', 'inds'):
            np.testing.assert_array_equal(g[k][..., i], r[k][..., i],
                                          err_msg=f'replica {i}: {k}')
        for side, (x, lcc_fresh) in sides.items():
            kept = np.array_equal(x['slices'][:, i], s0['slices'][:, i])
            taken = np.array_equal(x['lcc'][:, i], lcc_fresh[:, i])
            assert kept or taken, f'replica {i}: {side} is neither outcome'
        pair = np.stack([r['lcc'][:, i], g['lcc'][:, i]], axis=1)
        totals = np.asarray(jcosts.log2_total_from_lcc(jnp.asarray(pair),
                                                       n_leaves))
        assert abs(totals[0] - totals[1]) <= TOTAL_ATOL, (
            f'replica {i}: reslice decided {totals} apart, over the float '
            f'bound {TOTAL_ATOL}')
        g['slices'][:, i] = r['slices'][:, i]
        g['lcc'][:, i] = r['lcc'][:, i]
        settled.append(i)
    return settled


@pytest.mark.parametrize('net', ['lattice', 'mixed'])
def test_ref_slicer_matches_jax(random_seed, net):
    """``slicer='ref'`` (no union planes; the reslice unpacks the state
    and runs the reference-shaped slicer) against the JAX engine's 'ref'
    branch, one iteration at a time, on dims 2 (where the slicer takes
    the sorted-space path through K1) and on mixed dims 2 and 3 (pinned
    widths; the 'auto' choice there too)."""
    schedule = [(0.5, True), (2.0, False), (8.0, True), (1.0, True),
                (30.0, True)]
    applied = taken = 0
    seed = random_seed % 1000
    _, cfg, log2d_w32, _, ul = _setup(net, seed)
    for it, start, ref, got, mref, mgot in _iterations(net, seed, schedule,
                                                       'ref'):
        what = f'{net} iteration {it}'
        g = batch_fw_to_numpy(got)
        reslice_ties(start, ref, g, log2d_w32, ul, cfg.n_leaves)
        _assert_same(ref, g, what)
        assert int(mgot['applied']) == int(mref['applied']), what
        np.testing.assert_array_equal(mgot['pos'].numpy(),
                                      np.asarray(mref['pos']), err_msg=what)
        applied += int(mref['applied'])
        taken += int((np.asarray(ref.slices) !=
                      np.asarray(start.slices)).any(axis=0).sum())
    assert applied > 0
    assert taken > 0, 'no replica took a new slice set'


def test_ref_slicer_equals_plane_on_uniform_dims(random_seed):
    """On uniform power-of-two dims the two slicers give one result:
    ``slicer='ref'`` equals the plane slicer bitwise, totals included."""
    batch, cfg, log2d_w32, max_width, ul = _setup('lattice',
                                                  random_seed % 1000)
    w = cfg.n_lanes
    tcfg = TConfigFW(n_leaves=cfg.n_leaves, n_lanes=w)
    gen = torch.Generator().manual_seed(random_seed)
    draws = [tsw.draw_walks(gen, cfg.n_leaves, B, P, 32 * w, torch.float32)
             for _ in range(6)]
    draws = {k: torch.stack([d[k] for d in draws]) for k in draws[0]}
    betas = [0.5, 2.0, 8.0, 1.0, 30.0, 3.0]
    mask = [True, False, True, True, False, True]
    outs = []
    for slicer in (None, 'plane', 'ref'):
        out, m = tsw.run_walks_fw(
            batch_fw_from_numpy(_fields(batch), 'cpu'), betas, mask,
            max_width, torch.from_numpy(np.array(log2d_w32)),
            torch.zeros(w, dtype=torch.int32), tcfg,
            torch.full((P, B), -1, dtype=torch.int32), uniform_log2=ul,
            slicer=slicer, draws=draws, device='cpu')
        outs.append((batch_fw_to_numpy(out), int(m['applied'])))
    (plane, a0), *others = outs
    assert a0 > 0
    for got, applied in others:
        assert applied == a0
        for k, v in plane.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def _packed(batch, cfg):
    """The JAX engine's packed FW state with union planes, both sides."""
    w = cfg.n_lanes
    S = jsw._pack_w(batch.c0, batch.c1, batch.par, batch.inds, batch.lcc,
                    width=batch.width)
    U = (jsw.gather_gbn(S, jsw._i32(S[w]), planes=(0, w)) |
         jsw.gather_gbn(S, jsw._i32(S[w + 1]), planes=(0, w)))
    S = jnp.concatenate([S[:w], U, S[w:]], axis=0)
    St = torch.from_numpy(np.asarray(S).view(np.int32).copy())
    return S, St


@pytest.mark.parametrize('net', ['lattice', 'random'])
def test_propose_accept_claim_match_jax(random_seed, net):
    batch, cfg, log2d_w32, max_width, ul = _setup(net, random_seed % 1000)
    w = cfg.n_lanes
    tcfg = TConfigFW(n_leaves=cfg.n_leaves, n_lanes=w)
    S, St = _packed(batch, cfg)
    dr = _jax_draws(batch.keys, cfg)
    lt = jsw._lt_from_S(S, w, 1, cfg.n_leaves, jnp.float32, u=w)
    lt_t = tsw._lt_from_S(St, w, 1, cfg.n_leaves, torch.float32, u=w)
    np.testing.assert_allclose(lt_t.numpy(), np.asarray(lt), rtol=0,
                               atol=TOTAL_ATOL)
    slices = batch.slices
    slices_t = torch.from_numpy(np.asarray(slices).view(np.int32).copy())
    pos = jnp.full((B, P), -1, jnp.int32)
    # Second round from the advanced positions exercises mid-walk rows.
    for rnd in range(2):
        pos_j, ev = jsw._propose_walks(
            S, pos, jnp.asarray(dr['leaf'].numpy()),
            jnp.asarray(dr['rand_bit'].numpy()), cfg, log2d_w32, ul,
            jnp.float32, None, None, None, slices_wb=slices,
            with_width=True, u=w)
        pos_t, ev_t = tsw._propose_walks(
            St, torch.from_numpy(np.asarray(pos).copy()), dr['leaf'],
            dr['rand_bit'], tcfg, torch.from_numpy(np.array(log2d_w32)),
            ul, torch.float32, slices_wb=slices_t, with_width=True, u=w)
        np.testing.assert_array_equal(pos_t.numpy(), np.asarray(pos_j))
        for k, v in ev.items():
            np.testing.assert_array_equal(
                ev_t[k].numpy().view(np.int32) if ev_t[k].dtype ==
                torch.int32 else ev_t[k].numpy(),
                np.asarray(v).view(np.int32) if np.asarray(v).dtype ==
                np.uint32 else np.asarray(v), err_msg=f'round {rnd}: {k}')
        for beta in (0.0, 1.0, 6.0):
            acc = jsw._accept_walks(ev, lt, jnp.asarray(dr['u'].numpy()),
                                    jnp.float32(beta), cfg)
            acc_t = tsw._accept_walks(ev_t, lt_t, dr['u'],
                                      torch.tensor(beta))
            diff = acc_t.numpy() != np.asarray(acc)
            if diff.any():
                l_new = tsw.costs_ops.new_total_log2(
                    lt_t[:, None], ev_t['l_a'], ev_t['l_b'], ev_t['ln_a'],
                    ev_t['ln_b'])
                margin = (torch.log2(dr['u']) + beta *
                          (l_new - lt_t[:, None])).abs()
                raise AssertionError(
                    f'accept differs at {np.argwhere(diff).tolist()}; '
                    f'Metropolis margins there '
                    f'{margin.numpy()[diff].tolist()} (float bound '
                    f'{TOTAL_ATOL})')
            keep = jsw._claim_sequential(acc, ev)
            keep_t = tsw._claim_sequential(acc_t, ev_t)
            np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep))
        pos = ev['a']


@pytest.mark.parametrize('net', ['lattice', 'random'])
def test_greedy_slices_fast_matches_jax(random_seed, net):
    batch, cfg, log2d_w32, _, ul = _setup(net, random_seed % 1000)
    w = cfg.n_lanes
    S, St = _packed(batch, cfg)
    width_nb = jsw._join_f(S[2 * w + 3:2 * w + 4], jnp.float32).T
    # Tight caps force many over-width nodes and many slices.
    for cap in (2.0, 3.0, 4.0):
        for k in range(2):
            keys = jax.random.split(jax.random.PRNGKey(random_seed + k), B)
            want = jsfb._greedy_slices_fast(
                None, width_nb, keys, jnp.float32(cap), log2d_w32,
                jnp.zeros((w, 1), jnp.uint32), ul, vals=S,
                vals_planes=(0, w))
            jitter = jax.vmap(lambda key: jax.random.uniform(
                key, (w * 32,), dtype=jnp.float32))(keys).T
            got = tsfb._greedy_slices_fast(
                St, (0, w), torch.from_numpy(np.asarray(width_nb).copy()),
                torch.from_numpy(np.ascontiguousarray(jitter)),
                torch.tensor(cap), torch.from_numpy(np.array(log2d_w32)),
                torch.zeros(w, dtype=torch.int32), ul)
            assert np.asarray(want).any()
            np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                          np.asarray(want),
                                          err_msg=f'cap {cap}')


def _popcount_nb(words_nwb):
    """Set bits per [n, b] over the words of a uint32 [n, w, b] array."""
    x = np.ascontiguousarray(words_nwb.transpose(0, 2, 1)).view(np.uint8)
    return np.unpackbits(x, axis=2).sum(axis=2)


@pytest.mark.parametrize('n', [200, 300])
@pytest.mark.parametrize('cap', [6.0, 12.0])
def test_greedy_slices_fast_last_window_matches_reference(random_seed, n,
                                                         cap):
    """More than 128 * (n // 128) nodes over the cap, n not a multiple of
    the 128-node window: the port's fast slicer reads the last window
    padded and equals the JAX reference path bitwise, with every sliced
    width within the cap.  (The JAX fast path clamps that window's start
    and differs here; it is not the reference for these cases.)"""
    r = np.random.default_rng(random_seed)
    w, b = 2, 2
    inds = r.integers(0, 2**32, (n, w, b), dtype=np.uint32)
    width = _popcount_nb(inds).astype(np.float32)             # [n, b]
    assert ((width > cap).sum(axis=0) > 128 * (n // 128)).all()
    log2d_w32 = np.ones((w, 32), np.float32)
    keys = jax.random.split(jax.random.PRNGKey(random_seed), b)
    want = jsfb._greedy_slices_b(
        None, jnp.asarray(inds), jnp.asarray(width), keys,
        jnp.float32(cap), jnp.asarray(log2d_w32),
        jnp.zeros((w, 1), jnp.uint32), None, None, uniform_log2=None)
    jitter = jax.vmap(lambda key: jax.random.uniform(
        key, (w * 32,), dtype=jnp.float32))(keys).T
    vals = torch.from_numpy(inds.transpose(1, 2, 0).view(np.int32).copy())
    got = tsfb._greedy_slices_fast(
        vals, (0, w), torch.from_numpy(width),
        torch.from_numpy(np.ascontiguousarray(jitter)), torch.tensor(cap),
        torch.from_numpy(log2d_w32), torch.zeros(w, dtype=torch.int32),
        1.0)
    slices = got.numpy().view(np.uint32)                      # [w, b]
    np.testing.assert_array_equal(slices, np.asarray(want))
    assert _popcount_nb(inds & ~slices[None]).max() <= cap


def test_unported_options_raise(random_seed):
    batch, cfg, log2d_w32, max_width, ul = _setup('lattice', 3)
    w = cfg.n_lanes
    tb = batch_fw_from_numpy(_fields(batch), 'cpu')
    args = (tb, [1.0], [False], max_width,
            torch.from_numpy(np.array(log2d_w32)),
            torch.zeros(w, dtype=torch.int32),
            TConfigFW(n_leaves=cfg.n_leaves, n_lanes=w),
            torch.full((P, B), -1, dtype=torch.int32))
    gen = torch.Generator()
    # The walk variants are ported: they run (their parity with the JAX
    # engine is tests/test_torch_walk_variants.py's).
    for kw in ({'claim': 'pairwise'}, {'on_block': 'restart'},
               {'accept_rule': 'chained'}):
        kw.setdefault('uniform_log2', ul)
        _, m = tsw.run_walks_fw(*args, generator=gen, device='cpu', **kw)
        assert m['moves'] == P * B
    # The plane slicer needs uniform power-of-two dims (sa_walks.py:753).
    for kw in ({'slicer': 'plane', 'uniform_log2': None},
               {'slicer': 'plane', 'uniform_log2': float(np.log2(3))},
               {'slicer': 'bogus', 'uniform_log2': ul}):
        with pytest.raises(ValueError, match='slicer'):
            tsw.run_walks_fw(*args, generator=gen, device='cpu', **kw)
    _, m = tsw.run_walks_fw(*args[:6], TConfigFW(n_leaves=cfg.n_leaves,
                                                 n_lanes=w,
                                                 prob_kind='greedy'),
                            args[7], uniform_log2=ul, generator=gen,
                            device='cpu')
    assert m['moves'] == P * B
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if torch.cuda.is_available():
            raise RuntimeError("device='cpu' (CUDA present)")
        tsw.run_walks_fw(*args, uniform_log2=ul, generator=gen)

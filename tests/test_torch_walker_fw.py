"""The port's finite-width walker (K5-FW's plain route), FW multi-walk
engine and reference slicer vs the JAX package.

Each engine comparison starts both sides from one state (the JAX
``SABatchFW`` carried across with :mod:`tnco_tpu_torch.convert`) and feeds
the port the JAX draws: ``sa_multiwalk._draws(keys, n_leaves, P, f32, 5)``
under ``jax.lax.scan``, as ``pallas_walker.run_walker_fw`` draws them, and
the reslice jitter of the fifth key (``jax.random.uniform(k_res,
(n_bits,))`` per replica) where the mask is true.  One iteration is
compared at a time, over 12 iterations with reslices at 0, 5 and 10,
against ``sa_multiwalk.run_multiwalk_fw`` and
``pallas_walker.run_walker_fw(interpret=True)``: positions, counters,
trees, index words, hyper, lcc, widths, slices and the min state
bitwise; totals within 1e-5 in log2 (the exp2/log2 gap between XLA and
torch, PERF.md "Float bound").  A walk whose Metropolis margin is under
that bound would be a legitimate disagreement: the assertions name the
smallest margins instead of loosening anything.  The CUDA kernel itself
runs only on the card (the ``cuda``-marked test).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tnco_tpu.ctree import ContractionTree
from tnco_tpu.kernels import pallas_walker as jpw
from tnco_tpu.kernels import sa_finite_batched as jsfb
from tnco_tpu.kernels import sa_multiwalk as jsmw
from tnco_tpu.kernels.sa_finite import SweepConfigFW
from tnco_tpu.kernels.sa_fullsweep import uniform_log2_dim
from tnco_tpu.ops import bitops as jbit
from tnco_tpu.testing.utils import generate_random_tensors
from tnco_tpu.utils.tn import get_random_contraction_path
from tnco_tpu_torch.convert import batch_fw_from_numpy, batch_fw_to_numpy
from tnco_tpu_torch.kernels import sa_batched as tsb
from tnco_tpu_torch.kernels import sa_finite_batched as tsfb
from tnco_tpu_torch.kernels import sa_multiwalk as tsmw
from tnco_tpu_torch.kernels import walker as tw
from tnco_tpu_torch.kernels.sa_finite import SweepConfigFW as TConfigFW
from tnco_tpu_torch.ops import costs as tcosts
from torch_reference_native import reference_native  # noqa: F401

TOTAL_ATOL = 1e-5
B = 3
MAX_WIDTH = 3.0
_TOTALS = ('log2_total', 'min_log2_total')


def _setup(net, seed, n_tensors=12, n_extra_edges=8):
    """Both packages' state on one random network: dim 2, mixed dims
    (2 to 5) or dim 3 (a uniform, non-integer log2 dim)."""
    kw = dict(n_tensors=n_tensors, n_extra_edges=n_extra_edges,
              n_output_inds=1)
    if net == 'mixed':
        ts, out, dims = generate_random_tensors(seed, min_dim=2, max_dim=5,
                                                **kw)
        assert len(set(dims.values())) > 1
    else:
        d = 2 if net == 'dim2' else 3
        ts, out, dims = generate_random_tensors(seed, min_dim=d, max_dim=d,
                                                use_mixed_labels=False, **kw)
    order = tuple(dict.fromkeys(x for xs in ts for x in xs))
    trees = []
    for r in range(B):
        (path,) = [p for p in get_random_contraction_path(
            ts, out, merge_paths=False, seed=seed + r) if p]
        trees.append(ContractionTree(path, ts, dims, output_inds=out,
                                     check_shared_inds=True,
                                     inds_order=order))
    t = trees[0]
    w = t.inds_array.shape[1]
    log2d = np.array(jbit.pad_log2_dims(t.log2_dims_array, w))
    batch = jsfb.init_batch_fw(trees, [seed + r for r in range(B)],
                               MAX_WIDTH, log2d)
    cfg = SweepConfigFW(n_leaves=t.n_leaves, n_lanes=w)
    tcfg = TConfigFW(n_leaves=t.n_leaves, n_lanes=w)
    return batch, cfg, tcfg, log2d.reshape(w, 32), \
        uniform_log2_dim(t.log2_dims_array)


def _fields(batch):
    return {k: np.asarray(getattr(batch, k)) for k in batch.__slots__}


def _t(x):
    return torch.from_numpy(np.array(x, order='C'))


def _jax_draws(keys, cfg, p, reslice):
    """One iteration's draws of ``run_walker_fw`` (``pallas_walker.py:
    659-667``) in the port's layout: ``[1, P, B]`` streams and ``[R,
    n_bits, B]`` jitter (R = 1 at a reslice, else 0)."""
    def draw_step(keys, _):
        keys, leaf, rand_bit, u, (k_res,) = jsmw._draws(
            keys, cfg.n_leaves, p, jnp.float32, 5)
        return keys, (leaf, rand_bit, u, k_res)

    _, (leaf, rand_bit, u, k_res) = jax.lax.scan(draw_step, keys, None,
                                                 length=1)
    jitter = jax.vmap(lambda k: jax.random.uniform(
        k, (cfg.n_lanes * 32,), dtype=jnp.float32))(k_res[0]).T
    return {'leaf': _t(leaf), 'rand_bit': _t(rand_bit), 'u': _t(u),
            'jitter': _t(jitter)[None][:int(reslice)]}


def _margins(tb, dr, beta, log2d_w32, tcfg, pos):
    """The port's smallest Metropolis margins ``|log2 u + beta (l_new -
    lt)|`` of one iteration, as ``(margin, replica, walk)``."""
    n = tb.c0.shape[0]
    st = tsmw.padded_state(tb.c0, tb.c1, tb.par, tb.inds, tb.lcc, tb.width)
    lt = tsb._log2_total_b(tb.lcc, tcfg.n_leaves)
    ev = tsmw._propose(st, pos.T, dr['leaf'][0].T, dr['rand_bit'][0].T,
                       tcfg, n)
    sl = tb.slices[:, :, None]
    ln_b = tsb._width_b((ev['inds_d'] | ev['inds_c']) | sl, log2d_w32)
    ln_a = tsb._width_b((ev['new_inds_b'] | ev['inds_e']) | sl, log2d_w32)
    l_new = tcosts.new_total_log2(lt[:, None], ev['l_a'], ev['l_b'], ln_a,
                                  ln_b)
    m = (torch.log2(dr['u'][0].T) + beta * (l_new - lt[:, None])).abs()
    return sorted((float(m[b, p]), b, p) for b in range(m.shape[0])
                  for p in range(m.shape[1]))[:3]


def _compare(ref, mref, got, mgot, what, margins):
    g = batch_fw_to_numpy(got)
    try:
        for k, v in _fields(ref).items():
            if k == 'keys':
                continue
            if k in _TOTALS:
                np.testing.assert_allclose(g[k], v, rtol=0, atol=TOTAL_ATOL,
                                           err_msg=f'{what}: {k}')
            else:
                np.testing.assert_array_equal(g[k], v, err_msg=f'{what}: {k}')
        np.testing.assert_array_equal(mgot['pos'].numpy(),
                                      np.asarray(mref['pos']), err_msg=what)
        assert mgot['moves'] == int(mref['moves']), what
        assert int(mgot['applied']) == int(mref['applied']), what
    except AssertionError as e:
        raise AssertionError(
            f'{e}\nSmallest Metropolis margins (margin, replica, walk): '
            f'{margins()} (float bound {TOTAL_ATOL})') from None


@pytest.mark.parametrize('net', ['dim2', 'mixed', 'dim3'])
def test_slicer_and_cost_match_jax(random_seed, net):
    """``_greedy_slices_b`` and ``_lcc_fw_b`` against the JAX functions on
    one ``(inds, width, jitter)``: the reference path (no
    ``uniform_log2``) on every network, the port's uniform route on dim 2
    (the plane slicer and popcount costs) against JAX's reference path,
    and the uniform non-integer route (8 nodes per round) on dim 3.
    Slices and lcc bitwise."""
    seed = random_seed % 1000
    batch, _, _, log2d_w32, ul = _setup(net, seed, n_tensors=22,
                                        n_extra_edges=24)
    w = log2d_w32.shape[0]
    args = (batch.c0, batch.inds, batch.width)
    targs = tuple(_t(np.asarray(x).view(np.int32) if x.dtype == jnp.uint32
                     else x) for x in args)
    c1 = _t(batch.c1)
    # JAX route -> the port's routes held against it.
    if net == 'dim2':
        routes = {None: (None, ul)}
    elif net == 'dim3':
        routes = {None: (None,), ul: (ul,)}
    else:
        routes = {None: (None,)}
    n_sliced = 0
    for cap in (2.0, 3.0, 4.5):
        keys = jax.random.split(jax.random.PRNGKey(seed + int(cap)), B)
        jitter = jax.vmap(lambda k: jax.random.uniform(
            k, (w * 32,), dtype=jnp.float32))(keys).T
        for jroute, troutes in routes.items():
            want = jsfb._greedy_slices_b(
                *args, keys, jnp.float32(cap), jnp.asarray(log2d_w32),
                jnp.zeros((w, 1), jnp.uint32), None, None,
                uniform_log2=jroute)
            want_lcc = jsfb._lcc_fw_b(batch.c0, batch.c1, batch.inds, want,
                                      jnp.asarray(log2d_w32), None, None,
                                      uniform_log2=jroute)
            n_sliced += int(np.count_nonzero(np.asarray(want)))
            for troute in troutes:
                got = tsfb._greedy_slices_b(
                    *targs, _t(jitter), torch.tensor(cap), _t(log2d_w32),
                    torch.zeros(w, dtype=torch.int32), uniform_log2=troute)
                got_lcc = tsfb._lcc_fw_b(targs[0], c1, targs[1], got,
                                         _t(log2d_w32), uniform_log2=troute)
                what = f'cap {cap}, routes {jroute} / {troute}'
                np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                              np.asarray(want), err_msg=what)
                np.testing.assert_array_equal(got_lcc.numpy(),
                                              np.asarray(want_lcc),
                                              err_msg=what)
    assert n_sliced > 0


def test_blocked_cumsum_is_sequential_in_blocks():
    """The slicer's prefix sum adds in XLA's CPU order: 16-term blocks
    one term at a time, then the exclusive scan of the block totals."""
    r = np.random.default_rng(0)
    for n in (5, 16, 32, 64, 384, 2048):
        x = (r.random((n, 3)) * np.log2(r.integers(2, 6, (n, 3)))).astype(
            np.float32)
        np.testing.assert_array_equal(
            tsfb._cumsum_blocked(torch.from_numpy(x)).numpy(),
            np.asarray(jnp.cumsum(jnp.asarray(x), axis=0)), err_msg=str(n))


@pytest.mark.parametrize('net,p,with_walker', [
    ('dim2', 4, True), ('dim2', 8, False), ('mixed', 4, False),
    ('mixed', 8, True)])
def test_iterations_match_jax(random_seed, net, p, with_walker):
    """One iteration at a time over 12, reslices at 0, 5 and 10: the
    port's ``run_multiwalk_fw`` (reference slicer) and ``run_walker_fw``
    (its plain route; on dim 2 with the plane slicer) against the JAX
    ``run_multiwalk_fw`` and, where marked, ``run_walker_fw`` in
    interpret mode (one interpret call per iteration is slow, so each
    P meets the JAX walker on one network)."""
    batch, cfg, tcfg, log2d_w32, ul = _setup(net, random_seed % 1000)
    w = cfg.n_lanes
    jlog2d = jnp.asarray(log2d_w32)
    tlog2d = _t(log2d_w32)
    skip = jnp.zeros(w, jnp.uint32)
    tskip = torch.zeros(w, dtype=torch.int32)
    pos = jnp.full((p, B), -1, jnp.int32)
    applied = reslices = 0
    for it in range(12):
        beta = (0.0, 0.5, 1.0, 2.0, 4.0, 8.0)[it % 6] * (1 + it // 6)
        mask = [it % 5 == 0]
        draws = _jax_draws(batch.keys, cfg, p, mask[0])
        start = batch_fw_from_numpy(_fields(batch), 'cpu')
        pos_t = _t(pos)
        betas = jnp.asarray([beta], jnp.float32)
        ref, mref = jsmw.run_multiwalk_fw(batch, betas, jnp.asarray(mask),
                                          MAX_WIDTH, jlog2d, skip, cfg, p,
                                          pos)
        what = f'iteration {it} (beta={beta}, reslice={mask[0]})'

        def margins():
            return _margins(start, draws, beta, tlog2d, tcfg, pos_t)

        got, mgot = tsmw.run_multiwalk_fw(start, [beta], mask, MAX_WIDTH,
                                          tlog2d, tskip, tcfg, p, pos_t,
                                          draws=draws)
        _compare(ref, mref, got, mgot, what + ': run_multiwalk_fw',
                 margins)
        got, mgot = tw.run_walker_fw(start, [beta], mask, MAX_WIDTH, tlog2d,
                                     tskip, tcfg, p, pos_t, uniform_log2=ul,
                                     draws=draws)
        _compare(ref, mref, got, mgot, what + ': run_walker_fw', margins)
        if with_walker:
            pref, mpref = jpw.run_walker_fw(batch, betas, np.asarray(mask),
                                            MAX_WIDTH, jlog2d, skip, cfg, p,
                                            pos, interpret=True)
            _compare(pref, mpref, got, mgot, what + ' vs pallas walker',
                     margins)
        if mask[0] and np.asarray(batch.slices).any():
            reslices += 1
        applied += int(mref['applied'])
        batch, pos = ref, mref['pos']
    assert applied > 0 and reslices >= 1


def _random_draws(seed, k, p, b, cfg, mask):
    r = np.random.default_rng(seed)
    return {'leaf': torch.from_numpy(r.integers(
        0, cfg.n_leaves, (k, p, b)).astype(np.int32)),
        'rand_bit': torch.from_numpy(r.integers(0, 2, (k, p, b)) > 0),
        'u': torch.from_numpy(r.random((k, p, b)).astype(np.float32)),
        'jitter': torch.from_numpy(r.random(
            (int(np.count_nonzero(mask)), cfg.n_lanes * 32, b)).astype(
                np.float32))}


def _assert_batches_equal(a, b, what):
    ga, gb = batch_fw_to_numpy(a), batch_fw_to_numpy(b)
    for k in ga:
        np.testing.assert_array_equal(ga[k].view(np.uint32),
                                      gb[k].view(np.uint32),
                                      err_msg=f'{what}: {k}')


@pytest.mark.parametrize('net,update_slices', [
    ('dim2', 10), ('mixed', 10), ('mixed', 1), ('dim2', 2)])
def test_walker_segments_equal_multiwalk(random_seed, net, update_slices):
    """``run_walker_fw`` (segments split at the reslice points, reslices
    on the packed rows) == ``run_multiwalk_fw`` bitwise over one call of
    25 iterations with the mask at ``arange(25) % update_slices == 0``
    (``update_slices=1``: every segment one iteration long)."""
    batch, _, tcfg, log2d_w32, ul = _setup(net, random_seed % 1000)
    start = batch_fw_from_numpy(_fields(batch), 'cpu')
    k, p = 25, 8
    mask = np.arange(k) % update_slices == 0
    draws = _random_draws(random_seed, k, p, B, tcfg, mask)
    args = (start, torch.linspace(0.0, 8.0, k), mask, MAX_WIDTH,
            _t(log2d_w32), torch.zeros(tcfg.n_lanes, dtype=torch.int32), tcfg,
            p, torch.full((p, B), -1, dtype=torch.int32))
    got, mg = tw.run_walker_fw(*args, uniform_log2=ul, draws=draws)
    want, mw = tsmw.run_multiwalk_fw(*args, uniform_log2=ul, draws=draws)
    _assert_batches_equal(got, want, 'walker vs multiwalk')
    assert torch.equal(mg['pos'], mw['pos'])
    assert mg['moves'] == mw['moves'] == k * p * B
    assert int(mg['applied']) == int(mw['applied']) > 0
    assert np.asarray(batch.slices).any()


def test_continuation_is_bitwise(random_seed):
    """Two walker calls of 10 and 15 iterations, the mask cut from the
    global ``arange(25) % 10 == 0``, == one call of 25."""
    batch, _, tcfg, log2d_w32, _ = _setup('mixed', random_seed % 1000)
    start = batch_fw_from_numpy(_fields(batch), 'cpu')
    k, p = 25, 8
    mask = np.arange(k) % 10 == 0
    draws = _random_draws(random_seed, k, p, B, tcfg, mask)
    betas = torch.linspace(0.0, 8.0, k)
    rest = (MAX_WIDTH, _t(log2d_w32),
            torch.zeros(tcfg.n_lanes, dtype=torch.int32), tcfg, p)
    pos = torch.full((p, B), -1, dtype=torch.int32)
    whole, mw = tw.run_walker_fw(start, betas, mask, *rest, pos, draws=draws)
    r1 = int(np.count_nonzero(mask[:10]))
    d1 = {k_: v[:10] for k_, v in draws.items()}
    d1['jitter'] = draws['jitter'][:r1]
    d2 = {k_: v[10:] for k_, v in draws.items()}
    d2['jitter'] = draws['jitter'][r1:]
    mid, m1 = tw.run_walker_fw(start, betas[:10], mask[:10], *rest, pos,
                               draws=d1)
    got, m2 = tw.run_walker_fw(mid, betas[10:], mask[10:], *rest, m1['pos'],
                               draws=d2)
    _assert_batches_equal(whole, got, 'continuation')
    assert torch.equal(mw['pos'], m2['pos'])
    assert mw['moves'] == m1['moves'] + m2['moves']
    assert int(mw['applied']) == int(m1['applied']) + int(m2['applied']) > 0


def test_generator_draws_are_reproducible(random_seed):
    batch, _, tcfg, log2d_w32, ul = _setup('dim2', random_seed % 1000)
    start = batch_fw_from_numpy(_fields(batch), 'cpu')
    args = (start, [0.0, 1.0, 3.0, 5.0], [True, False, True, False],
            MAX_WIDTH, _t(log2d_w32),
            torch.zeros(tcfg.n_lanes, dtype=torch.int32), tcfg, 8,
            torch.full((8, B), -1, dtype=torch.int32))
    outs = []
    for fn in (tw.run_walker_fw, tsmw.run_multiwalk_fw):
        gen = torch.Generator()
        gen.manual_seed(random_seed)
        outs.append(fn(*args, uniform_log2=ul, generator=gen)[0])
    _assert_batches_equal(outs[0], outs[1], 'generator draws')
    with pytest.raises(ValueError, match='draws= or generator='):
        tw.run_walker_fw(*args)


def test_segments_split_after_each_reslice():
    assert tw.segments(np.arange(25) % 10 == 0) == [
        (0, 1, True), (1, 11, True), (11, 21, True), (21, 25, False)]
    assert tw.segments([True] * 3) == [(0, 1, True), (1, 2, True),
                                       (2, 3, True)]
    assert tw.segments([False] * 4) == [(0, 4, False)]
    assert tw.segments([False, False, True]) == [(0, 3, True)]


def test_fw_rows_roundtrip_and_kernel_inputs(random_seed):
    """The FW rows (header c0, c1, par, lcc, width; index words; the
    slice row N), built here as on the card."""
    r = np.random.default_rng(random_seed)
    for w in (1, 3, 4, 64, 123):
        n, b = int(r.integers(3, 300)) | 1, 2

        def ints(shape, lo=-1, hi=n):
            return torch.from_numpy(r.integers(lo, hi, shape).astype(np.int32))

        c0, c1, par = (ints((n, b)) for _ in range(3))
        lcc, width = (torch.from_numpy(np.exp2(r.uniform(
            -60, 60, (n, b))).astype(np.float32)) for _ in range(2))
        inds = ints((n, w, b), -2**31, 2**31)
        slices = ints((w, b), -2**31, 2**31)
        rows = tw.pack_rows_fw(c0, c1, par, lcc, inds, width, slices)
        assert rows.shape == (b, n + 1, tw.row_words_fw(w))
        assert rows.shape[2] % 4 == 0 and rows.shape[2] >= 5 + w
        assert not rows[:, :, 5 + w:].any()
        assert (rows[:, n, :3] == -1).all()
        assert torch.isneginf(rows[:, n, 3].view(torch.float32)).all()
        for x, y in zip((c0, c1, par, lcc, inds, width, slices),
                        tw.unpack_rows_fw(rows, w)):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    assert tw.row_words_fw(64) == 72
    assert tw.walker_supported_fw(3241, 1621, 64)
    assert tw.walker_supported_fw(31, 16, 123)
    assert not tw.walker_supported_fw(31, 16, 124)
    batch, _, tcfg, _, _ = _setup('mixed', 3)
    tb = batch_fw_from_numpy(_fields(batch), 'cpu')
    for shape in ((1, B), (8, 1)):
        pos = torch.full(shape, -1, dtype=torch.int32)
        b1 = tsfb.SABatchFW(*(getattr(tb, f)[..., :shape[1]] if f != 'keys'
                              else tb.keys[:shape[1]]
                              for f in tsfb.SABatchFW.field_names()))
        seg = tw.kernel_inputs_fw(b1, pos)
        # The launches update pos_bp in place: never a view of pos.
        assert seg['pos_bp'].is_contiguous()
        assert seg['pos_bp'].data_ptr() != pos.data_ptr()
        assert seg['applied'].shape == (shape[1],)
        np.testing.assert_array_equal(
            tw.unpack_rows_fw(seg['min_rows'], tcfg.n_lanes)[6].numpy(),
            b1.min_slices.numpy())


def test_unsupported_and_unported_raise():
    batch, _, tcfg, log2d_w32, _ = _setup('dim2', 5)
    tb = batch_fw_from_numpy(_fields(batch), 'cpu')
    w = tcfg.n_lanes
    gen = torch.Generator()
    args = (tb, [1.0], [True], MAX_WIDTH, _t(log2d_w32),
            torch.zeros(w, dtype=torch.int32), tcfg, 4,
            torch.full((4, B), -1, dtype=torch.int32))
    # The walk schedules and chained acceptance are ported: they run.
    for kw in ({'on_block': 'restart'}, {'accept_rule': 'chained'}):
        _, m = tsmw.run_multiwalk_fw(*args, generator=torch.Generator()
                                     .manual_seed(5), **kw)
        assert m['moves'] == 4 * B
    # Sparse indices: the multi-walk engine takes them (an empty sparse
    # set gives the dense run), the walker refuses them as JAX's does.
    sparse = {'sparse_wb': torch.zeros((w, 1), dtype=torch.int32),
              'log2_n_projs': 3.0}
    runs = [tsmw.run_multiwalk_fw(*args, generator=torch.Generator()
                                  .manual_seed(5), **kw)[0]
            for kw in ({}, sparse)]
    for name in tsfb.SABatchFW.field_names():
        assert torch.equal(getattr(runs[0], name), getattr(runs[1], name))
    with pytest.raises(NotImplementedError, match='dense cost model only'):
        tw.run_walker_fw(*args, generator=gen, **sparse)
    # Float64 state runs on the multi-walk engine; the walker refuses it
    # naming float32.
    t64 = dataclasses.replace(tb, **{k: getattr(tb, k).double() for k in (
        'lcc', 'width', 'log2_total', 'min_log2_total')})
    out, _ = tsmw.run_multiwalk_fw(t64, *args[1:4], args[4].double(),
                                   *args[5:], generator=torch.Generator()
                                   .manual_seed(5))
    assert out.lcc.dtype == out.width.dtype == torch.float64
    with pytest.raises(ValueError, match='float32'):
        tw.run_walker_fw(t64, *args[1:4], args[4].double(), *args[5:],
                         generator=gen)
    with pytest.raises(ValueError, match='n_walks'):
        tw.run_walker_fw(*args[:7], 129, torch.full((129, B), -1,
                                                    dtype=torch.int32),
                         generator=gen)
    with pytest.raises(ValueError, match='walker_supported_fw'):
        tw.run_walker_fw(*args[:6], TConfigFW(n_leaves=tb.c0.shape[0],
                                              n_lanes=w), *args[7:],
                         generator=gen)
    with pytest.raises(ValueError, match='must match betas'):
        tw.run_walker_fw(*args[:2], [True, False], *args[3:], generator=gen)
    bad = _random_draws(0, 1, 4, B, tcfg, [True, True])
    with pytest.raises(ValueError, match="draws\\['jitter'\\]"):
        tw.run_walker_fw(*args, draws=bad)
    dense = tsfb._lcc_fw_b(tb.c0, tb.c1, tb.inds, tb.slices, args[4])
    assert torch.equal(tsfb._lcc_fw_b(tb.c0, tb.c1, tb.inds, tb.slices,
                                      args[4], **sparse), dense)


def _skip_without_card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the CUDA kernels have no CPU '
                    'mode); run python3 chip_smoke.py on the card')


def _check_kernel_fw_chunks(tb, tlog2d, tcfg, p, ul, seed, max_width, k=12,
                            every=5):
    """Two chained chunks of the FW walker on K5-FW and of
    ``run_walker_fw_plain`` on the same draws, reslices inside: every
    batch field, pos and the counters bitwise.  Returns the last state,
    positions, betas and draws."""
    dev = tb.c0.device
    b = tb.c0.shape[1]
    skip = torch.zeros(tcfg.n_lanes, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pos = torch.full((p, b), -1, dtype=torch.int32, device=dev)
    mask = np.arange(k) % every == 0
    for chunk in range(2):
        betas = torch.linspace(4.0 * chunk, 4.0 * chunk + 4.0, k,
                               device=dev)
        draws = tsmw.draw_chunk_fw(gen, tcfg.n_leaves, k, p, b,
                                   tcfg.n_lanes * 32, int(mask.sum()))
        pos0 = pos.clone()
        got, mg = tw.run_walker_fw(tb, betas, mask, max_width, tlog2d, skip,
                                   tcfg, p, pos, uniform_log2=ul,
                                   draws=draws)
        assert torch.equal(pos, pos0)              # the input is not updated
        want, mw = tw.run_walker_fw_plain(tb, betas, mask, max_width, tlog2d,
                                          skip, tcfg, p, pos,
                                          uniform_log2=ul, draws=draws)
        _assert_batches_equal(got, want, f'chunk {chunk}')
        assert torch.equal(mg['pos'], mw['pos'])
        assert int(mg['applied']) == int(mw['applied'])
        tb, pos = got, mg['pos']
    return tb, pos, betas, draws


@pytest.mark.cuda
@pytest.mark.parametrize('p,b,net,prob_kind', [
    (1, 3, 'mixed', 'mh'), (8, 1, 'mixed', 'mh'), (8, 3, 'mixed', 'mh'),
    (40, 3, 'mixed', 'mh'), (128, 3, 'mixed', 'mh'),
    (8, 3, 'mixed', 'greedy'), (128, 3, 'mixed', 'greedy'),
    (8, 3, 'dim2', 'mh'), (128, 3, 'dim2', 'greedy')])
def test_walker_fw_kernel_matches_plain_on_card(random_seed, p, b, net,
                                                prob_kind):
    """K5-FW against ``run_walker_fw_plain`` on the same draws, two
    chained chunks with reslices: every batch field, pos and the
    counters bitwise; and one segment launch against the plain segment
    on the same packed rows.  Mixed dims take the kernel's tree width
    route, dim 2 its popcount route; P=128 runs the longest claim scan,
    'greedy' many dirty-row snapshots."""
    _skip_without_card()
    batch, _, tcfg, log2d_w32, ul = _setup(net, random_seed % 1000)
    tcfg = dataclasses.replace(tcfg, prob_kind=prob_kind)
    dev = torch.device('cuda')
    tb = batch_fw_from_numpy(_fields(batch), dev)
    tb = tsfb.SABatchFW(*(getattr(tb, f)[..., :b] if f != 'keys'
                          else tb.keys[:b]
                          for f in tsfb.SABatchFW.field_names()))
    tlog2d = _t(log2d_w32).to(dev)
    tb, pos, betas, draws = _check_kernel_fw_chunks(
        tb, tlog2d, tcfg, p, ul, random_seed, MAX_WIDTH)
    segs = [tw.kernel_inputs_fw(tb, pos) for _ in range(2)]
    dr = {k: v[:5].to(torch.int32 if k != 'u' else torch.float32)
          .contiguous() for k, v in draws.items() if k != 'jitter'}
    tw.walker_fw_segment(segs[0], dr, betas[:5], tlog2d, tcfg, MAX_WIDTH,
                         True)
    tw.walker_fw_segment_plain(segs[1], dr, betas[:5], tlog2d, tcfg,
                               MAX_WIDTH, True)
    for k in ('rows', 'pos_bp', 'min_lt', 'applied'):
        assert torch.equal(segs[0][k].view(torch.int32),
                           segs[1][k].view(torch.int32)), k
    # The min rows' lcc and width words are not part of the min state.
    for i in (0, 1, 2, 4, 6):
        assert torch.equal(
            tw.unpack_rows_fw(segs[0]['min_rows'], tcfg.n_lanes)[i],
            tw.unpack_rows_fw(segs[1]['min_rows'], tcfg.n_lanes)[i]), i


@pytest.mark.cuda
@pytest.mark.parametrize('dim', [2, 3])
def test_walker_fw_kernel_global_topology_on_card(random_seed, dim):
    """K5-FW on a network whose topology does not fit in shared memory
    (the 7001-tensor hyper-index chain, N=14001, W=110: the kernel's
    global-topology instantiation), B=2, K=8, max_width 4 with a reslice
    every 4; dim 3 takes the tree width route."""
    _skip_without_card()
    from tnco_tpu_torch.ctree import ContractionTree as TContractionTree
    from tnco_tpu_torch.kernels.sa_fullsweep import (
        uniform_log2_dim as t_uniform_log2_dim)
    from tnco_tpu_torch.ops import bitops as tbit
    from tnco_tpu_torch.testing.networks import hyper_chain_tn
    from tnco_tpu_torch.utils.tn import get_random_contraction_path as tpath

    ts, out, dims = hyper_chain_tn(7001, dim)
    trees = [TContractionTree(tpath(ts, out, seed=s), ts, dims,
                              output_inds=out) for s in (0, 1)]
    t = trees[0]
    w = t.inds_array.shape[1]
    log2d = tbit.pad_log2_dims(t.log2_dims_array, w)
    dev = torch.device('cuda')
    tb = tsfb.init_batch_fw(trees, [0, 1], 4.0, log2d.numpy(), device=dev)
    tcfg = TConfigFW(n_leaves=t.n_leaves, n_lanes=w)
    _check_kernel_fw_chunks(tb, log2d.reshape(w, 32).to(dev), tcfg, 8,
                            t_uniform_log2_dim(t.log2_dims_array),
                            random_seed, 4.0, k=8, every=4)

"""The port's walker (K5's plain version) and IM batch vs the JAX package.

Each comparison starts both sides from one state (the JAX ``SABatch``
carried across with :mod:`tnco_tpu_torch.convert`) and feeds the port the
JAX draws: ``jax.lax.scan`` over ``sa_multiwalk._draws(keys, n_leaves, P,
f32, 4)``, exactly as ``pallas_walker._run_walker`` draws them.  One
iteration is compared at a time, for six iterations in turn, against both
``pallas_walker.run_walker(interpret=True)`` and
``sa_multiwalk.run_multiwalk``: positions, counters, trees, index words,
hyper, lcc and the min state bitwise; totals within 1e-5 in log2 (the
exp2/log2 gap between XLA and torch, PERF.md "Float bound").  A walk whose
Metropolis margin is under that bound would be a legitimate disagreement:
the assertions name the smallest margins instead of loosening anything.
The CUDA kernel itself runs only on the card (the ``cuda``-marked test).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tnco_tpu.ctree import ContractionTree
from tnco_tpu.kernels import pallas_walker as jpw
from tnco_tpu.kernels import sa_batched as jsb
from tnco_tpu.kernels import sa_multiwalk as jsmw
from tnco_tpu.kernels.sa_fullsweep import uniform_log2_dim
from tnco_tpu.kernels.sa_infinite import SweepConfig
from tnco_tpu.ops import bitops as jbit
from tnco_tpu.testing.utils import generate_random_tensors
from tnco_tpu.utils.tn import get_random_contraction_path
from tnco_tpu_torch.convert import batch_from_numpy, batch_to_numpy
from tnco_tpu_torch.ctree import ContractionTree as TContractionTree
from tnco_tpu_torch.kernels import sa_batched as tsb
from tnco_tpu_torch.kernels import sa_multiwalk as tsmw
from tnco_tpu_torch.kernels import walker as tw
from tnco_tpu_torch.kernels.sa_infinite import SweepConfig as TConfig
from tnco_tpu_torch.ops import costs as tcosts
from torch_reference_native import reference_native  # noqa: F401

TOTAL_ATOL = 1e-5
B = 3
_TOTALS = ('log2_total', 'min_log2_total')


def _setup(net, seed, prob_kind='mh', disable_shared_inds=False):
    """Both packages' trees on one random network; dim-2 or mixed dims."""
    kw = dict(n_tensors=10, n_extra_edges=6, n_output_inds=1)
    if net == 'dim2':
        ts, out, dims = generate_random_tensors(seed, min_dim=2, max_dim=2,
                                                use_mixed_labels=False, **kw)
    else:
        ts, out, dims = generate_random_tensors(seed, min_dim=2, max_dim=5,
                                                **kw)
        assert len(set(dims.values())) > 1
    order = tuple(dict.fromkeys(x for xs in ts for x in xs))
    trees, ttrees = [], []
    for r in range(B):
        (path,) = [p for p in get_random_contraction_path(
            ts, out, merge_paths=False, seed=seed + r) if p]
        kwt = dict(output_inds=out, check_shared_inds=True, inds_order=order)
        trees.append(ContractionTree(path, ts, dims, **kwt))
        ttrees.append(TContractionTree(path, ts, dims, **kwt))
    t = trees[0]
    w = t.inds_array.shape[1]
    log2d = np.array(jbit.pad_log2_dims(t.log2_dims_array, w))
    batch = jsb.init_batch(trees, [seed + r for r in range(B)], log2d)
    flags = dict(n_leaves=t.n_leaves, n_lanes=w, prob_kind=prob_kind,
                 disable_shared_inds=disable_shared_inds)
    cfg, tcfg = SweepConfig(**flags), TConfig(**flags)
    return (batch, ttrees, cfg, tcfg, log2d,
            uniform_log2_dim(t.log2_dims_array))


def _fields(batch):
    return {k: np.asarray(getattr(batch, k)) for k in batch.__slots__}


def _jax_draws(keys, cfg, p, k=1):
    """The walker's draws (``pallas_walker.py:514-520``), ``[K, P, B]``."""
    def draw_step(keys, _):
        keys, leaf, rand_bit, u, _ = jsmw._draws(keys, cfg.n_leaves, p,
                                                 jnp.float32, 4)
        return keys, (leaf, rand_bit, u)

    _, (leaf, rand_bit, u) = jax.lax.scan(draw_step, keys, None, length=k)
    return {name: torch.from_numpy(np.array(x)) for name, x in
            (('leaf', leaf), ('rand_bit', rand_bit), ('u', u))}


def _margins(tb, draws, beta, log2d_w32, tcfg, pos, ul):
    """The port's smallest Metropolis margins ``|log2 u + beta (l_new -
    lt)|`` of one iteration, as ``(margin, replica, walk)``."""
    n = tb.c0.shape[0]
    st = dict(c0=tb.c0, c1=tb.c1, par=tb.par, inds=tb.inds, lcc=tb.lcc)
    lt = tsb._log2_total_b(tb.lcc, tcfg.n_leaves)
    ev = tsmw._propose(st, pos.T, draws['leaf'][0].T,
                       draws['rand_bit'][0].T, tcfg, n)
    ln_b = tsb._width_b(ev['inds_d'] | ev['inds_c'], log2d_w32,
                        uniform_log2=ul)
    ln_a = tsb._width_b(ev['new_inds_b'] | ev['inds_e'], log2d_w32,
                        uniform_log2=ul)
    l_new = tcosts.new_total_log2(lt[:, None], ev['l_a'], ev['l_b'], ln_a,
                                  ln_b)
    m = (torch.log2(draws['u'][0].T) + beta * (l_new - lt[:, None])).abs()
    return sorted((float(m[b, p]), b, p) for b in range(m.shape[0])
                  for p in range(m.shape[1]))[:3]


def _compare(ref, mref, got, mgot, what, margins):
    g = batch_to_numpy(got)
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


@pytest.mark.parametrize('net', ['dim2', 'mixed'])
def test_init_batch_matches_jax(random_seed, net):
    batch, ttrees, _, _, log2d, _ = _setup(net, random_seed % 1000)
    seeds = [random_seed % 1000 + r for r in range(B)]
    got = batch_to_numpy(tsb.init_batch(ttrees, seeds, log2d,
                                        device='cpu'))
    for k, v in _fields(batch).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize('net,p,prob_kind,no_shared', [
    ('dim2', 4, 'mh', False), ('dim2', 8, 'mh', False),
    ('mixed', 4, 'mh', False), ('mixed', 8, 'mh', False),
    ('mixed', 8, 'greedy', True)])
def test_one_iteration_matches_jax(random_seed, net, p, prob_kind,
                                   no_shared):
    batch, _, cfg, tcfg, log2d, ul = _setup(net, random_seed % 1000,
                                            prob_kind, no_shared)
    w = cfg.n_lanes
    log2d_w32 = jnp.asarray(log2d).reshape(w, 32)
    tlog2d = torch.from_numpy(np.array(log2d_w32))
    pos = jnp.full((p, B), -1, jnp.int32)
    applied = 0
    for it, beta in enumerate((0.0, 0.5, 2.0, 5.0, 10.0, 30.0)):
        betas = jnp.asarray([beta], jnp.float32)
        draws = _jax_draws(batch.keys, cfg, p)
        start = batch_from_numpy(_fields(batch), 'cpu')
        pos_t = torch.from_numpy(np.array(pos))
        ref, mref = jsmw.run_multiwalk(batch, betas, log2d_w32, cfg, p, pos,
                                       uniform_log2=ul)
        got, mgot = tw.run_walker(start, torch.tensor([beta]), tlog2d, tcfg,
                                  p, pos_t, draws=draws)
        what = f'iteration {it} (beta={beta})'

        def margins():
            return _margins(start, draws, beta, tlog2d, tcfg, pos_t, ul)

        _compare(ref, mref, got, mgot, what + ' vs run_multiwalk', margins)
        if prob_kind == 'mh':       # the JAX walker runs 'mh' only here
            pref, mpref = jpw.run_walker(batch, betas, log2d_w32, cfg, p,
                                         pos, interpret=True)
            _compare(pref, mpref, got, mgot, what + ' vs pallas walker',
                     margins)
        applied += int(mref['applied'])
        batch, pos = ref, mref['pos']
    assert applied > 0


def test_continuation_is_bitwise(random_seed):
    """Two port calls of 10 and 10 iterations == one call of 20."""
    _, ttrees, _, tcfg, log2d, _ = _setup('mixed', random_seed % 1000)
    p = 8
    r = np.random.default_rng(random_seed)
    draws = {'leaf': torch.from_numpy(r.integers(
        0, tcfg.n_leaves, (20, p, B)).astype(np.int32)),
        'rand_bit': torch.from_numpy(r.integers(0, 2, (20, p, B)) > 0),
        'u': torch.from_numpy(r.random((20, p, B)).astype(np.float32))}
    betas = torch.linspace(0.0, 8.0, 20)
    batch = tsb.init_batch(ttrees, [1, 2, 3], log2d, device='cpu')
    log2d_w32 = torch.from_numpy(log2d).reshape(-1, 32)
    pos = torch.full((p, B), -1, dtype=torch.int32)
    whole, mw = tw.run_walker(batch, betas, log2d_w32, tcfg, p, pos,
                              draws=draws)
    half = {k: v[:10] for k, v in draws.items()}
    rest = {k: v[10:] for k, v in draws.items()}
    mid, m1 = tw.run_walker(batch, betas[:10], log2d_w32, tcfg, p, pos,
                            draws=half)
    got, m2 = tw.run_walker(mid, betas[10:], log2d_w32, tcfg, p, m1['pos'],
                            draws=rest)
    a, b = batch_to_numpy(whole), batch_to_numpy(got)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(mw['pos'].numpy(), m2['pos'].numpy())
    assert mw['moves'] == m1['moves'] + m2['moves'] == 20 * p * B
    assert int(mw['applied']) == int(m1['applied']) + int(m2['applied']) > 0


def test_generator_draws_are_reproducible(random_seed):
    _, ttrees, _, tcfg, log2d, _ = _setup('dim2', random_seed % 1000)
    batch = tsb.init_batch(ttrees, [0, 1, 2], log2d, device='cpu')
    log2d_w32 = torch.from_numpy(log2d).reshape(-1, 32)
    pos = torch.full((8, B), -1, dtype=torch.int32)
    outs = []
    for _ in range(2):
        gen = torch.Generator()
        gen.manual_seed(random_seed)
        outs.append(batch_to_numpy(tw.run_walker(
            batch, [0.0, 1.0, 3.0], log2d_w32, tcfg, 8, pos,
            generator=gen)[0]))
    for k in outs[0]:
        np.testing.assert_array_equal(outs[0][k], outs[1][k], err_msg=k)
    with pytest.raises(ValueError, match='draws= or generator='):
        tw.run_walker(batch, [1.0], log2d_w32, tcfg, 8, pos)


def test_rows_roundtrip_and_kernel_inputs(random_seed):
    """The kernel's packed operands, built here as on the card."""
    r = np.random.default_rng(random_seed)
    for w in (1, 3, 4, 64, 124):
        n, b, k, p = int(r.integers(3, 300)) | 1, 2, 5, 8
        c0, c1, par = (torch.from_numpy(r.integers(-1, n, (n, b)).astype(
            np.int32)) for _ in range(3))
        lcc = torch.from_numpy(np.exp2(r.uniform(-60, 60, (n, b))).astype(
            np.float32))
        inds = torch.from_numpy(r.integers(-2**31, 2**31, (n, w, b)).astype(
            np.int32))
        rows = tw.pack_rows(c0, c1, par, lcc, inds)
        assert rows.shape == (b, n, tw.row_words(w))
        assert rows.shape[2] % 4 == 0 and rows.is_contiguous()
        assert not rows[:, :, 4 + w:].any()
        for x, y in zip((c0, c1, par, lcc, inds), tw.unpack_rows(rows, w)):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    batch = tsb.SABatch(c0, c1, par, inds, inds, lcc, lcc[0], lcc[0], c0,
                        c1, par, inds, torch.zeros((b, 2), dtype=torch.int32))
    draws = {'leaf': torch.zeros((k, p, b), dtype=torch.int32),
             'rand_bit': torch.zeros((k, p, b), dtype=torch.bool),
             'u': torch.zeros((k, p, b))}
    pos = torch.full((p, b), -1, dtype=torch.int32)
    ops = tw.kernel_inputs(batch, torch.zeros(k), torch.zeros((w, 32)), pos,
                           draws)
    assert ops['pos_bp'].shape == (b, p)
    # The launch writes pos_bp in place: never a view of the caller's pos
    # (pos.T of a [1, B] or [P, 1] tensor is contiguous already).
    for shape in ((1, b), (p, 1)):
        pos1 = torch.full(shape, -1, dtype=torch.int32)
        b1 = tsb.SABatch(*(x[..., :shape[1]] for x in (
            c0, c1, par, inds, inds, lcc, lcc[0], lcc[0], c0, c1, par, inds)),
            torch.zeros((shape[1], 2), dtype=torch.int32))
        d1 = {k: v[:, :shape[0], :shape[1]] for k, v in draws.items()}
        o1 = tw.kernel_inputs(b1, torch.zeros(k), torch.zeros((w, 32)), pos1,
                              d1)
        assert o1['pos_bp'].is_contiguous()
        assert o1['pos_bp'].data_ptr() != pos1.data_ptr()
    assert all(x.dtype == torch.int32 for x in
               (ops['draws']['leaf'], ops['draws']['rand_bit']))
    assert ops['log2d'].shape == (w * 32,)
    with pytest.raises(ValueError, match="draws\\['leaf'\\]"):
        tw.kernel_inputs(batch, torch.zeros(k + 1), torch.zeros((w, 32)),
                         pos, draws)


def test_unsupported_and_unported_raise():
    _, ttrees, _, tcfg, log2d, _ = _setup('dim2', 5)
    batch = tsb.init_batch(ttrees, [0, 1, 2], log2d, device='cpu')
    log2d_w32 = torch.from_numpy(log2d).reshape(-1, 32)
    pos = torch.full((4, B), -1, dtype=torch.int32)
    gen = torch.Generator()
    args = (batch, [1.0], log2d_w32, tcfg, 4, pos)
    # The walk schedules and chained acceptance are ported: they run.
    for kw in ({'on_block': 'restart'}, {'accept_rule': 'chained'}):
        _, m = tsmw.run_multiwalk(*args, generator=torch.Generator()
                                  .manual_seed(5), **kw)
        assert m['moves'] == 4 * B
    # Sparse indices: the multi-walk engine takes them (an empty sparse
    # set gives the dense run), the walker refuses them as JAX's does.
    sparse = {'sparse_wb': torch.zeros((tcfg.n_lanes, 1), dtype=torch.int32),
              'log2_n_projs': 3.0}
    runs = [tsmw.run_multiwalk(*args, generator=torch.Generator()
                               .manual_seed(5), **kw)[0]
            for kw in ({}, sparse)]
    for name in tsb.SABatch.field_names():
        assert torch.equal(getattr(runs[0], name), getattr(runs[1], name))
    with pytest.raises(NotImplementedError, match='dense cost model only'):
        tw.run_walker(*args, generator=gen, **sparse)
    # Float64 state runs on the multi-walk engine; the walker, whose
    # kernel holds one 32-bit lcc lane, refuses it naming float32.
    b64 = tsb.init_batch(ttrees, [0, 1, 2], log2d, dtype=np.float64,
                         device='cpu')
    out, _ = tsmw.run_multiwalk(b64, [1.0], log2d_w32.double(), *args[3:],
                                generator=torch.Generator().manual_seed(5))
    assert out.lcc.dtype == out.min_log2_total.dtype == torch.float64
    with pytest.raises(ValueError, match='float32'):
        tw.run_walker(b64, [1.0], log2d_w32.double(), *args[3:],
                      generator=gen)
    with pytest.raises(ValueError, match='n_walks'):
        tw.run_walker(*args[:4], 129, torch.full((129, B), -1,
                                                 dtype=torch.int32),
                      generator=gen)
    assert not tw.walker_supported(1, 1, 4)
    assert not tw.walker_supported(31, 16, 125)
    assert tw.walker_supported(3241, 1621, 64)
    with pytest.raises(ValueError, match='walker_supported'):
        tw.run_walker(*args[:3], TConfig(n_leaves=batch.c0.shape[0],
                                         n_lanes=tcfg.n_lanes), *args[4:],
                      generator=gen)


def _skip_without_card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the CUDA kernels have no CPU '
                    'mode); run python3 chip_smoke.py on the card')


def _check_kernel_chunks(batch, log2d_w32, tcfg, p, seed, k=12):
    """Two chained chunks of K5 and of ``run_walker_plain`` on the same
    draws: every batch field, pos and the counters bitwise."""
    dev = batch.c0.device
    b = batch.c0.shape[1]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pos = torch.full((p, b), -1, dtype=torch.int32, device=dev)
    applied = 0
    for chunk in range(2):
        betas = torch.linspace(4.0 * chunk, 4.0 * chunk + 4.0, k,
                               device=dev)
        draws = tsmw.draw_chunk(gen, tcfg.n_leaves, k, p, b)
        pos0 = pos.clone()
        got, mg = tw.run_walker(batch, betas, log2d_w32, tcfg, p, pos,
                                draws=draws)
        assert torch.equal(pos, pos0)              # the input is not updated
        want, mw = tw.run_walker_plain(batch, betas, log2d_w32, tcfg, p,
                                       pos, draws=draws)
        g, w = batch_to_numpy(got), batch_to_numpy(want)
        for f in g:
            np.testing.assert_array_equal(g[f].view(np.uint32),
                                          w[f].view(np.uint32), err_msg=f)
        assert torch.equal(mg['pos'], mw['pos'])
        assert int(mg['applied']) == int(mw['applied'])
        applied += int(mg['applied'])
        batch, pos = got, mg['pos']
    assert applied > 0


@pytest.mark.cuda
@pytest.mark.parametrize('p,b,net,prob_kind', [
    (1, 3, 'mixed', 'mh'), (8, 1, 'mixed', 'mh'), (8, 3, 'mixed', 'mh'),
    (40, 3, 'mixed', 'mh'), (128, 3, 'mixed', 'mh'),
    (8, 3, 'mixed', 'greedy'), (128, 3, 'mixed', 'greedy'),
    (8, 3, 'dim2', 'mh'), (128, 3, 'dim2', 'greedy')])
def test_walker_kernel_matches_plain_on_card(random_seed, p, b, net,
                                             prob_kind):
    """K5 against ``run_walker_plain`` on the same draws: mixed dims take
    the kernel's tree width route, dim 2 its popcount route; P=128 runs
    the longest claim scan, 'greedy' many dirty-row snapshots."""
    _skip_without_card()
    _, ttrees, _, tcfg, log2d, _ = _setup(net, random_seed % 1000,
                                          prob_kind)
    dev = torch.device('cuda')
    batch = tsb.init_batch(ttrees[:b], list(range(b)), log2d, device=dev)
    log2d_w32 = torch.from_numpy(log2d).reshape(-1, 32).to(dev)
    _check_kernel_chunks(batch, log2d_w32, tcfg, p, random_seed)


@pytest.mark.cuda
@pytest.mark.parametrize('dim', [2, 3])
def test_walker_kernel_global_topology_on_card(random_seed, dim):
    """K5 on a network whose topology does not fit in shared memory (the
    7001-tensor hyper-index chain, N=14001, W=110: the kernel's
    global-topology instantiation), B=2, K=8; dim 3 takes the tree width
    route."""
    _skip_without_card()
    from tnco_tpu_torch.ops import bitops as tbit
    from tnco_tpu_torch.testing.networks import hyper_chain_tn
    from tnco_tpu_torch.utils.tn import get_random_contraction_path as tpath

    ts, out, dims = hyper_chain_tn(7001, dim)
    trees = [TContractionTree(tpath(ts, out, seed=s), ts, dims,
                              output_inds=out) for s in (0, 1)]
    t = trees[0]
    w = t.inds_array.shape[1]
    log2d = tbit.pad_log2_dims(t.log2_dims_array, w).numpy()
    dev = torch.device('cuda')
    batch = tsb.init_batch(trees, [0, 1], log2d, device=dev)
    tcfg = TConfig(n_leaves=t.n_leaves, n_lanes=w)
    log2d_w32 = torch.from_numpy(log2d).reshape(w, 32).to(dev)
    _check_kernel_chunks(batch, log2d_w32, tcfg, 8, random_seed, k=8)

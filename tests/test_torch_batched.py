"""The port's lockstep 'batched' engine and move stream (infinite memory)
vs the JAX package's ``sa_batched``.

Each comparison starts both sides from one state (the JAX ``SABatch``
carried across with :mod:`tnco_tpu_torch.convert`) and feeds the port the
JAX draws, mirrored from the replicas' threefry keys: per sweep a 2-way
split for the leaf, then per walk step a 3-way split for the bit and the
uniform (a replica's ``t``-th step always takes the ``t``-th split, since
an inactive replica keeps its key).  One sweep (or stream iteration) is
compared at a time, over 8 sweeps with the JAX state fed back: trees,
index words, hyper, lcc, the min state and ``moves`` bitwise; totals
within 1e-5 in log2 (the exp2/log2 gap between XLA and torch, PERF.md
"Float bound").  A decision whose Metropolis margin is under that bound
would be a legitimate disagreement: the assertions name the smallest
margins of the sweep instead of loosening anything.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from benchmarks.networks import lattice_2d
from tnco_tpu.ctree import ContractionTree
from tnco_tpu.kernels import sa_batched as jsb
from tnco_tpu.kernels.sa_fullsweep import uniform_log2_dim
from tnco_tpu.kernels.sa_infinite import SweepConfig
from tnco_tpu.ops import bitops as jbit
from tnco_tpu.testing.utils import generate_random_tensors
from tnco_tpu.utils.tn import get_random_contraction_path
from tnco_tpu_torch.convert import batch_from_numpy, batch_to_numpy
from tnco_tpu_torch.kernels import sa_batched as tsb
from tnco_tpu_torch.kernels.sa_infinite import SweepConfig as TConfig
from torch_reference_native import reference_native  # noqa: F401

TOTAL_ATOL = 1e-5
B = 4
_TOTALS = ('log2_total', 'min_log2_total')


def network(kind, seed):
    """A network of more than 32 indices (W >= 2): a 5x6 lattice (dim 2),
    a random one on dims 2 to 5, or a dim-2 one with hyper indices."""
    if kind == 'lattice':
        return lattice_2d(5, 6)
    kw = dict(n_tensors=16, n_extra_edges=24, n_output_inds=1)
    if kind == 'mixed':
        ts, out, dims = generate_random_tensors(seed, min_dim=2, max_dim=5,
                                                **kw)
        assert len(set(dims.values())) > 1
        return ts, out, dims
    return generate_random_tensors(seed, min_dim=2, max_dim=2,
                                   n_hyper_edges=3, n_hyper_output_inds=1,
                                   use_mixed_labels=False, **kw)


def trees(ts, out, dims, seed, b=B):
    order = tuple(dict.fromkeys(x for xs in ts for x in xs))
    res = []
    for r in range(b):
        (path,) = [p for p in get_random_contraction_path(
            ts, out, merge_paths=False, seed=seed + r) if p]
        res.append(ContractionTree(path, ts, dims, output_inds=out,
                                   check_shared_inds=True, inds_order=order))
    assert res[0].inds_array.shape[1] >= 2
    return res


def _setup(kind, seed, prob_kind='mh', disable_shared_inds=False):
    ts, out, dims = network(kind, seed)
    ctrees = trees(ts, out, dims, seed)
    t = ctrees[0]
    w = t.inds_array.shape[1]
    log2d = np.array(jbit.pad_log2_dims(t.log2_dims_array, w))
    batch = jsb.init_batch(ctrees, [seed + r for r in range(B)], log2d)
    flags = dict(n_leaves=t.n_leaves, n_lanes=w, prob_kind=prob_kind,
                 disable_shared_inds=disable_shared_inds)
    return (batch, SweepConfig(**flags), TConfig(**flags),
            log2d.reshape(w, 32), uniform_log2_dim(t.log2_dims_array))


def fields(batch):
    return {k: np.asarray(getattr(batch, k)) for k in batch.__slots__}


def _t(x):
    return torch.from_numpy(np.array(x, order='C'))


_split2 = jax.vmap(lambda k: tuple(jax.random.split(k)))
_unif = jax.vmap(lambda k: jax.random.uniform(k, dtype=jnp.float32))


@functools.partial(jax.jit, static_argnums=(1, 2))
def _mirror_sweep(keys, n_leaves, n_steps):
    """``_sweep_batched``'s draws (``sa_batched.py:290-291,337,356,379``)
    for every step a replica may take."""
    keys, k_leaf = _split2(keys)
    leaf = jax.vmap(lambda k: jax.random.randint(k, (), 0, n_leaves))(k_leaf)

    def step(keys, _):
        keys, k_pick, k_u = jax.vmap(
            lambda k: tuple(jax.random.split(k, 3)))(keys)
        return keys, (jax.vmap(jax.random.bernoulli)(k_pick), _unif(k_u))

    _, (rand_bit, u) = jax.lax.scan(step, keys, None, length=n_steps)
    return leaf, rand_bit, u


def sweep_draws(keys, n_leaves):
    leaf, rand_bit, u = _mirror_sweep(keys, n_leaves,
                                      tsb.max_walk_steps(n_leaves))
    return {'leaf': _t(leaf)[None], 'rand_bit': _t(rand_bit)[None],
            'u': _t(u)[None]}


class Margins:
    """Records the margins of the port's accept decisions (every replica,
    walking or not) through ``tsb._accept``: ``|log2 u + beta (l_new -
    lt)|`` for 'mh', ``|l_new - lt|`` for 'greedy'."""

    def __init__(self, monkeypatch):
        self.seen = []
        original = tsb._accept

        def accept(prob_kind, log2_u, beta, l_new, l_old):
            if prob_kind != 'base':
                m = l_new - l_old
                m = (log2_u + beta * m if prob_kind == 'mh' else m).abs()
                self.seen.extend(float(x) for x in m.reshape(-1))
            return original(prob_kind, log2_u, beta, l_new, l_old)

        monkeypatch.setattr(tsb, '_accept', accept)

    def smallest(self):
        return sorted(self.seen)[:3]


def min_ties(prev, ref, got):
    """Settles the end-of-sweep min snapshots decided by a float tie.

    A replica whose new total ties its previous min within the float
    bound (``|lt - min_lt| <= TOTAL_ATOL``, ``lt`` computed by each side's
    own exp2/log2) may take the snapshot on one side and not on the
    other.  For those replicas the port's min fields must equal, all
    together, either the JAX result or the other outcome (the previous
    min state, or the new current state); they are then set to the JAX
    result, so that :func:`compare` checks every other field bitwise.
    Returns the replicas settled so."""
    names = [k[4:] for k in fields(ref) if k.startswith('min_') and
             k != 'min_log2_total']
    r, p = fields(ref), fields(prev)
    ties = np.flatnonzero(np.abs(r['log2_total'] - p['min_log2_total']) <=
                          TOTAL_ATOL)
    for i in ties:
        outcomes = ({k: r[f'min_{k}'][..., i] for k in names},
                    {k: p[f'min_{k}'][..., i] for k in names},
                    {k: r[k][..., i] for k in names})
        mine = {k: got[f'min_{k}'][..., i] for k in names}
        assert any(all(np.array_equal(mine[k], o[k]) for k in names)
                   for o in outcomes), f'replica {i}: min state'
        for k in names:
            got[f'min_{k}'][..., i] = r[f'min_{k}'][..., i]
    return ties


def compare(ref, got, what, margins=None, skip=('keys',)):
    """Every field of the JAX batch ``ref`` against the port's ``got``
    (numpy fields): totals within ``TOTAL_ATOL``, the rest bitwise."""
    try:
        for k, v in fields(ref).items():
            if k in skip:
                continue
            if k in _TOTALS:
                np.testing.assert_allclose(got[k], v, rtol=0,
                                           atol=TOTAL_ATOL,
                                           err_msg=f'{what}: {k}')
            else:
                np.testing.assert_array_equal(got[k], v,
                                              err_msg=f'{what}: {k}')
    except AssertionError as e:
        if margins is None:
            raise
        raise AssertionError(
            f'{e}\nSmallest Metropolis margins of the port: '
            f'{margins.smallest()} (float bound {TOTAL_ATOL})') from None


@pytest.mark.parametrize('kind,prob_kind,dsi', [
    ('lattice', 'mh', False),
    ('lattice', 'greedy', False),
    ('lattice', 'base', False),
    ('mixed', 'mh', False),
    ('mixed', 'greedy', True),
    ('hyper', 'mh', False),
    ('hyper', 'mh', True),
])
def test_sweep_matches_jax(monkeypatch, random_seed, kind, prob_kind, dsi):
    """One ``_sweep_batched`` at a time, 8 sweeps, JAX state fed back."""
    batch, cfg, tcfg, log2d_w32, ul = _setup(kind, random_seed % 1000,
                                             prob_kind, dsi)
    tlog2d = _t(log2d_w32)
    betas = np.linspace(0.5, 8.0, 8, dtype=np.float32)
    applied = 0
    for i, beta in enumerate(betas):
        margins = Margins(monkeypatch)
        dr = sweep_draws(batch.keys, cfg.n_leaves)
        ref, rm = jsb.run_sweeps_batched(batch, jnp.asarray([beta]),
                                         jnp.asarray(log2d_w32), cfg,
                                         uniform_log2=ul)
        tb = batch_from_numpy(fields(batch), 'cpu')
        got, gm = tsb.run_sweeps_batched(tb, [beta], tlog2d, tcfg,
                                         uniform_log2=ul, draws=dr)
        what = f'{kind} {prob_kind} dsi={dsi} sweep {i}'
        g = batch_to_numpy(got)
        min_ties(batch, ref, g)
        compare(ref, g, what, margins)
        assert int(gm['moves'][0]) == int(rm['moves'][0]) > 0, what
        np.testing.assert_allclose(gm['log2_total'].numpy(),
                                   np.asarray(rm['log2_total']), rtol=0,
                                   atol=TOTAL_ATOL)
        applied += int((np.asarray(ref.c0) != np.asarray(batch.c0)).sum())
        batch = ref
    assert applied > 0


def _sweeps_draws(batch, cfg, betas, log2d_w32, ul):
    """The draws of consecutive sweeps, mirrored from each sweep's
    starting keys (JAX run one sweep at a time), stacked ``[K, ...]``."""
    per = []
    for beta in betas:
        per.append(sweep_draws(batch.keys, cfg.n_leaves))
        batch, _ = jsb.run_sweeps_batched(batch, jnp.asarray([beta]),
                                          jnp.asarray(log2d_w32), cfg,
                                          uniform_log2=ul)
    return {k: torch.cat([d[k] for d in per]) for k in per[0]}


def test_run_histories_and_hyper(random_seed):
    """``run_sweeps_batched`` over a chunk of 5 sweeps: its histories,
    moves and refreshed ``hyper`` against ``_run``'s in one call."""
    batch, cfg, tcfg, log2d_w32, ul = _setup('hyper', random_seed % 1000)
    betas = np.linspace(1.0, 6.0, 5, dtype=np.float32)
    dr = _sweeps_draws(batch, cfg, betas, log2d_w32, ul)
    ref, rm = jsb.run_sweeps_batched(batch, jnp.asarray(betas),
                                     jnp.asarray(log2d_w32), cfg,
                                     uniform_log2=ul)
    tb = batch_from_numpy(fields(batch), 'cpu')
    got, gm = tsb.run_sweeps_batched(tb, betas, _t(log2d_w32), tcfg,
                                     uniform_log2=ul, draws=dr)
    g = batch_to_numpy(got)
    compare(ref, g, 'chunk')
    assert np.asarray(ref.hyper).any()
    np.testing.assert_array_equal(gm['moves'].numpy(), np.asarray(rm['moves']))
    for k in ('log2_total', 'log2_min_total'):
        np.testing.assert_allclose(gm[k].numpy(), np.asarray(rm[k]), rtol=0,
                                   atol=TOTAL_ATOL, err_msg=k)
    # The caller's batch is not modified.
    compare(batch, batch_to_numpy(tb), 'input', skip=())


@pytest.mark.parametrize('kind', ['lattice', 'mixed'])
def test_inactive_steps_are_noops(monkeypatch, random_seed, kind):
    """Asking the card whether any replica walks every step, or never
    (every walk runs its full bound of steps), gives the same state."""
    batch, cfg, tcfg, log2d_w32, ul = _setup(kind, random_seed % 1000)
    betas = np.linspace(1.0, 4.0, 3, dtype=np.float32)
    dr = _sweeps_draws(batch, cfg, betas, log2d_w32, ul)
    outs = []
    for every in (1, 5, 10**6):
        monkeypatch.setattr(tsb, 'ACTIVE_CHECK_STEPS', every)
        got, gm = tsb.run_sweeps_batched(
            batch_from_numpy(fields(batch), 'cpu'), betas, _t(log2d_w32),
            tcfg, uniform_log2=ul, draws=dr)
        outs.append((batch_to_numpy(got), gm))
    for g, gm in outs[1:]:
        for k, v in outs[0][0].items():
            np.testing.assert_array_equal(g[k], v, err_msg=k)
        for k, v in outs[0][1].items():
            assert torch.equal(gm[k], v), k


def test_generator_draws_reproducible(random_seed):
    batch, cfg, tcfg, log2d_w32, ul = _setup('lattice', random_seed % 1000)
    outs = []
    for seed in (7, 7, 8):
        gen = torch.Generator().manual_seed(seed)
        got, gm = tsb.run_sweeps_batched(
            batch_from_numpy(fields(batch), 'cpu'), [1.0, 2.0, 3.0],
            _t(log2d_w32), tcfg, uniform_log2=ul, generator=gen)
        outs.append(batch_to_numpy(got))
        assert gm['moves'].shape == (3,) and int(gm['moves'].sum()) > 0
    for k in outs[0]:
        np.testing.assert_array_equal(outs[1][k], outs[0][k], err_msg=k)
    assert any(not np.array_equal(outs[2][k], outs[0][k])
               for k in ('c0', 'c1', 'par'))
    # Drawn sweep streams: shapes, dtypes, ranges.
    d = tsb.draw_sweep(torch.Generator().manual_seed(1), cfg.n_leaves, B)
    n_steps = tsb.max_walk_steps(cfg.n_leaves)
    assert d['leaf'].dtype == torch.int32 and d['leaf'].shape == (B,)
    assert 0 <= int(d['leaf'].min()) and int(d['leaf'].max()) < cfg.n_leaves
    assert d['rand_bit'].dtype == torch.bool
    assert d['rand_bit'].shape == d['u'].shape == (n_steps, B)
    assert 0.0 <= float(d['u'].min()) and float(d['u'].max()) < 1.0


def test_malformed_draws_raise(random_seed):
    batch, cfg, tcfg, log2d_w32, ul = _setup('lattice', random_seed % 1000)
    tb = batch_from_numpy(fields(batch), 'cpu')
    good = sweep_draws(batch.keys, cfg.n_leaves)
    args = (tb, [1.0], _t(log2d_w32), tcfg)
    bad = [{k: v for k, v in good.items() if k != 'u'},
           dict(good, u=good['u'][:, :-1]),
           dict(good, leaf=good['leaf'].float()),
           dict(good, rand_bit=good['rand_bit'].int()),
           dict(good, u=good['u'].numpy())]
    for dr in bad:
        with pytest.raises(ValueError, match='draws'):
            tsb.run_sweeps_batched(*args, uniform_log2=ul, draws=dr)
    with pytest.raises(ValueError, match='generator'):
        tsb.run_sweeps_batched(*args, uniform_log2=ul)
    with pytest.raises(ValueError, match='prob_kind'):
        tsb.run_sweeps_batched(tb, [1.0], _t(log2d_w32),
                               TConfig(n_leaves=cfg.n_leaves,
                                       n_lanes=cfg.n_lanes,
                                       prob_kind='mh_local'),
                               uniform_log2=ul, draws=good)
    sdr = {k: v[0, :1] for k, v in good.items() if k != 'leaf'}
    sdr['leaf'] = good['leaf'][:, :B]
    with pytest.raises(ValueError, match='draws'):
        tsb.run_stream_batched(tb, [1.0], 2, _t(log2d_w32), tcfg,
                               torch.full((B,), -1), torch.zeros(B),
                               uniform_log2=ul, draws=sdr)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _mirror_stream(keys, n_leaves, n_iters):
    """``_stream_iter``'s draws (``sa_batched.py:516,543,568,588``): one
    3-way split per iteration, the leaf and the bit from one key."""
    def step(keys, _):
        keys, k_a, k_b = jax.vmap(
            lambda k: tuple(jax.random.split(k, 3)))(keys)
        leaf = jax.vmap(lambda k: jax.random.randint(k, (), 0, n_leaves))(
            k_a)
        return keys, (leaf, jax.vmap(jax.random.bernoulli)(k_a), _unif(k_b))

    _, out = jax.lax.scan(step, keys, None, length=n_iters)
    return out


@pytest.mark.parametrize('kind,prob_kind', [('lattice', 'mh'),
                                            ('mixed', 'greedy'),
                                            ('hyper', 'base')])
def test_stream_matches_jax(monkeypatch, random_seed, kind, prob_kind):
    """``_run_stream`` one iteration per call for 12 calls (replicas
    close sweeps and start new ones on their own), then one call of 6
    iterations, the state fed back each time."""
    batch, cfg, tcfg, log2d_w32, ul = _setup(kind, random_seed % 1000,
                                             prob_kind)
    tlog2d = _t(log2d_w32)
    betas = np.asarray([0.5, 2.0, 6.0], dtype=np.float32)
    pos_b = jnp.full((B,), -1, jnp.int32)
    sweep_cnt = jnp.zeros((B,), jnp.int32)
    total = 0
    for i, n_iters in enumerate([1] * 12 + [6]):
        margins = Margins(monkeypatch)
        leaf, rand_bit, u = _mirror_stream(batch.keys, cfg.n_leaves, n_iters)
        dr = {'leaf': _t(leaf), 'rand_bit': _t(rand_bit), 'u': _t(u)}
        ref, rm = jsb.run_stream_batched(
            batch, jnp.asarray(betas), n_iters, jnp.asarray(log2d_w32), cfg,
            pos_b, sweep_cnt, uniform_log2=ul)
        got, gm = tsb.run_stream_batched(
            batch_from_numpy(fields(batch), 'cpu'), betas, n_iters, tlog2d,
            tcfg, _t(pos_b), _t(sweep_cnt), uniform_log2=ul, draws=dr)
        what = f'{kind} {prob_kind} call {i}'
        compare(ref, batch_to_numpy(got), what, margins)
        for k in ('pos_b', 'sweep_cnt'):
            np.testing.assert_array_equal(gm[k].numpy(), np.asarray(rm[k]),
                                          err_msg=what)
        assert int(gm['moves']) == int(rm['moves']), what
        total += int(rm['moves'])
        batch, pos_b, sweep_cnt = ref, rm['pos_b'], rm['sweep_cnt']
    assert total > 0
    assert int(np.asarray(sweep_cnt).min()) >= 1


@pytest.mark.cuda
def test_card_sweep_matches_cpu(random_seed):
    """The card against the CPU on one chunk of 3 sweeps from one state
    and the same draws: integer and bit state bitwise, totals within the
    float bound."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    batch, cfg, tcfg, log2d_w32, ul = _setup('lattice', random_seed % 1000)
    betas = np.linspace(1.0, 4.0, 3, dtype=np.float32)
    dr = _sweeps_draws(batch, cfg, betas, log2d_w32, ul)
    outs = []
    for dev in ('cpu', 'cuda'):
        got, _ = tsb.run_sweeps_batched(
            batch_from_numpy(fields(batch), dev), betas,
            _t(log2d_w32).to(dev), tcfg, uniform_log2=ul,
            draws={k: v.to(dev) for k, v in dr.items()})
        outs.append(batch_to_numpy(got))
    for k, v in outs[0].items():
        if k in _TOTALS:
            np.testing.assert_allclose(outs[1][k], v, rtol=0,
                                       atol=TOTAL_ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(outs[1][k], v, err_msg=k)


def _lattice_tn(rows, cols):
    from tnco_tpu_torch.app.tn import Tensor, TensorNetwork
    ts, out, dims = lattice_2d(rows, cols)
    return TensorNetwork([Tensor(xs, tuple(dims[x] for x in xs))
                          for xs in ts], output_inds=out)


def test_runner_batched_end_to_end(random_seed):
    """``ReplicaRunner(engine='batched')`` on the CPU, and 'auto' picking
    it on a small network: sweeps, moves, no applied count (as the JAX
    runner), valid best trees whose exact cost is the device min total."""
    from tnco_tpu_torch.ctree import ContractionTree as TContractionTree
    from tnco_tpu_torch.parallel import ReplicaRunner
    ts, out, dims = lattice_2d(5, 6)
    ctrees = [TContractionTree(get_random_contraction_path(
        ts, out, seed=random_seed + i), ts, dims, output_inds=out)
        for i in range(4)]
    seeds = [random_seed + i for i in range(4)]
    auto = ReplicaRunner(ctrees, seeds, device='cpu')
    assert auto.engine == 'batched'
    runner = ReplicaRunner(ctrees, seeds, engine='batched', device='cpu')
    seen = []
    info = runner.run(np.linspace(0, 6, 10), chunk_size=4,
                      callback=seen.append)
    assert runner.sweeps_done == 12 and info['applied'] is None
    assert info['moves'] > 12 * 4
    assert [round(s['progress'], 2) for s in seen] == [0.4, 0.8, 1.0]
    mins = runner.log2_min_totals()
    for r in range(4):
        for tree in (runner.min_ctree(r), runner.ctree(r)):
            assert tree.is_valid(check_shared_inds=True)
        exact = runner.min_ctree(r).total_cost_exact()
        assert abs(np.log2(float(exact)) - mins[r]) < TOTAL_ATOL
    with pytest.raises(ValueError, match="engine='batched'"):
        ReplicaRunner(ctrees, seeds, engine='batched', on_block='restart',
                      device='cpu')


def test_optimizer_default_fuse(random_seed):
    """``Optimizer()`` end to end on the CPU with the default ``fuse``
    (a 6x6 lattice fuses to about 25 tensors): 'auto' runs 'batched' and every
    result is a valid path at its exact cost."""
    from decimal import Decimal
    from tnco_tpu_torch.app import Optimizer, load_tn
    from tnco_tpu_torch.app.infinite_memory import sa as im_sa
    from tnco_tpu_torch.ctree import ContractionTree as TContractionTree
    tn = _lattice_tn(6, 6)
    engines = []
    cls = im_sa.ReplicaRunner

    class Recorded(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self.engine)

    im_sa.ReplicaRunner = Recorded
    try:
        loaded, res = Optimizer(seed=random_seed, device='cpu').optimize(
            tn, betas=(0, 4), n_steps=6, n_runs=3)
    finally:
        im_sa.ReplicaRunner = cls
    assert engines == ['batched']
    assert 2 < loaded.n_tensors < load_tn(tn, fuse=0).n_tensors
    assert len(res) == 3 and res == sorted(res)
    for r in res:
        ctree = TContractionTree(r.path, loaded.ts_inds, loaded.dims,
                                 output_inds=loaded.output_inds)
        assert ctree.is_valid(check_shared_inds=True)
        assert r.cost == Decimal(0) + Decimal(ctree.total_cost_exact())


def test_device_rule_batched(monkeypatch):
    """Without CUDA the batched runner raises unless asked for the CPU;
    the engine runs on its batch's device."""
    from tnco_tpu_torch.ctree import ContractionTree as TContractionTree
    from tnco_tpu_torch.parallel import ReplicaRunner
    ts, out, dims = lattice_2d(3, 3)
    ctrees = [TContractionTree(get_random_contraction_path(ts, out, seed=0),
                               ts, dims, output_inds=out)]
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ReplicaRunner(ctrees, [0], engine='batched')
    runner = ReplicaRunner(ctrees, [0], engine='batched', device='cpu')
    runner.run([1.0, 2.0])
    assert runner.states.c0.device.type == 'cpu'

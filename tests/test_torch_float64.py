"""Float64 state in the port (the counterpart of ``tests/test_float64.py``,
its two single-optimizer cases included).

``cost_type='float64'`` runs the engines in float64 under the port's
float64 mode (``ops.bitops.enable_float64`` / ``set_float64``, the
counterparts of JAX's x64 flag) and in float32 outside it.  Each engine
case starts the port and the JAX package (under ``jax.enable_x64(True)``)
from one float64 state and feeds the port the JAX draws, drawn in
float64 as the JAX engines draw them: integer and bit state bitwise,
``lcc`` and widths bitwise, totals within ``TOTAL_ATOL64`` in log2.  That
bound is measured (``scripts/float64_gap.py``): the largest gap over
these cases' 66 total comparisons (the default ``PYTEST_SEED``) was
3.6e-15, a few ulps of the exp2/log2 sums, so 1e-12 holds them with
room, against 1e-5 in float32.  Min snapshots and reslices decided by a tie within the
float32 bound are settled as in the float32 tests
(``test_torch_batched.min_ties``, ``test_torch_walks.reslice_ties``).
"""

import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tnco_tpu.kernels import sa_batched as jsb
from tnco_tpu.kernels import sa_finite as jsaf
from tnco_tpu.kernels import sa_finite_batched as jsfb
from tnco_tpu.kernels import sa_fullsweep as jsfs
from tnco_tpu.kernels import sa_infinite as jsa
from tnco_tpu.kernels import sa_multiwalk as jsmw
from tnco_tpu.kernels import sa_walks as jsw
from tnco_tpu.kernels.sa_finite import SweepConfigFW
from tnco_tpu.kernels.sa_fullsweep import uniform_log2_dim
from tnco_tpu.kernels.sa_infinite import SweepConfig
from tnco_tpu.ops import bitops as jbit
from tnco_tpu.parallel import replicas as jrep
from tnco_tpu_torch.convert import (batch_from_numpy, batch_fw_from_numpy,
                                    batch_fw_to_numpy)
from tnco_tpu_torch.kernels import sa_batched as tsb
from tnco_tpu_torch.kernels import sa_finite as tsaf
from tnco_tpu_torch.kernels import sa_finite_batched as tsfb
from tnco_tpu_torch.kernels import sa_fullsweep as tsfs
from tnco_tpu_torch.kernels import sa_infinite as tsa
from tnco_tpu_torch.kernels import sa_multiwalk as tsmw
from tnco_tpu_torch.kernels import sa_walks as tsw
from tnco_tpu_torch.kernels import walker as tw
from tnco_tpu_torch.kernels.sa_finite import SweepConfigFW as TConfigFW
from tnco_tpu_torch.kernels.sa_infinite import SweepConfig as TConfig
from tnco_tpu_torch.ops import bitops as tbit
from tnco_tpu_torch.optimize.finite_width import SimpleCostModel as TFWModel
from tnco_tpu_torch.parallel import replicas as trep
from test_torch_batched import B, min_ties, network, trees
from test_torch_batched_fw import _walk_steps
from test_torch_walk_variants import B as WB
from test_torch_walk_variants import (MAX_WIDTH, compare, fields, jax_draws,
                                      port_fields, setup)
from test_torch_walks import reslice_ties
from torch_reference_native import reference_native  # noqa: F401

TOTAL_ATOL64 = 1e-12
F64 = jnp.float64


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


def _t(x):
    return torch.from_numpy(np.array(x, order='C'))


def test_device_dtype_and_float64_mode():
    """``device_dtype`` follows JAX's rule inside and outside the mode;
    the context manager restores the previous setting."""
    tags = ('float32', 'float64', 'float128', 'float1024')
    assert not tbit.float64_enabled()
    assert [tbit.device_dtype(t) for t in tags] == [torch.float32] * 4
    with tbit.enable_float64():
        assert tbit.float64_enabled()
        assert [tbit.device_dtype(t) for t in tags] == (
            [torch.float32] + [torch.float64] * 3)
        assert [jnp.dtype(jbit.device_dtype(t)).name for t in tags] == [
            str(tbit.device_dtype(t)).split('.')[1] for t in tags]
        with tbit.enable_float64(False):
            assert tbit.device_dtype('float64') == torch.float32
        assert tbit.device_dtype() == torch.float64
    assert tbit.device_dtype('float64') == torch.float32
    tbit.set_float64(True)
    try:
        assert tbit.device_dtype('float128') == torch.float64
    finally:
        tbit.set_float64(False)
    assert not tbit.float64_enabled()


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_split_join_roundtrip(random_seed, dtype):
    """``_split_f``/``_join_f``: the same planes as JAX's (the low word
    first), and back bitwise, specials included."""
    r = np.random.default_rng(random_seed)
    x = (r.standard_normal((5, 7)) * 10.0 ** r.integers(-30, 30, (5, 7))
         ).astype(dtype)
    x.flat[:6] = [np.inf, -np.inf, 0.0, -0.0, np.finfo(dtype).tiny / 4,
                  np.nan]
    planes = tsfs._split_f(torch.from_numpy(x))
    nk = 2 if dtype == np.float64 else 1
    assert tuple(planes.shape) == (nk, 5, 7) and tsfs._nk(
        planes.new_empty((), dtype=torch.from_numpy(x).dtype).dtype) == nk
    np.testing.assert_array_equal(
        planes.numpy(), np.asarray(jsfs._split_f(jnp.asarray(x))).view(
            np.int32))
    back = tsfs._join_f(planes, torch.from_numpy(x).dtype).numpy()
    assert back.view(np.uint8).tobytes() == x.view(np.uint8).tobytes()
    scalar = torch.tensor(2.5, dtype=torch.from_numpy(x).dtype)
    assert tsfs._join_f(tsfs._split_f(scalar), scalar.dtype) == 2.5


_split2 = jax.vmap(lambda k: tuple(jax.random.split(k)))
_unif64 = jax.vmap(lambda k: jax.random.uniform(k, dtype=F64))


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _mirror(keys, n_leaves, n_steps, n_bits):
    """The lockstep sweeps' draws in float64 (as ``test_torch_batched``
    and ``test_torch_batched_fw`` mirror them in float32): the leaf, and
    per walk step the bit, the uniform, the rescue's priorities and its
    second uniform (a 5-way split; the IM sweep splits 3 ways, so its
    mirror is :func:`_mirror_im`), and the key before each step."""
    keys, k_leaf = _split2(keys)
    leaf = jax.vmap(lambda k: jax.random.randint(k, (), 0, n_leaves))(k_leaf)

    def step(keys, _):
        nxt, k_pick, k_u, k_sl, k_u2 = jax.vmap(
            lambda k: tuple(jax.random.split(k, 5)))(keys)
        prio = jax.vmap(lambda k: jax.random.uniform(
            k, (n_bits,), dtype=F64))(k_sl).T
        return nxt, (keys, jax.vmap(jax.random.bernoulli)(k_pick),
                     _unif64(k_u), prio, _unif64(k_u2))

    last, (seen, rand_bit, u, prio, u2) = jax.lax.scan(step, keys, None,
                                                       length=n_steps)
    return leaf, rand_bit, u, prio, u2, jnp.concatenate([seen, last[None]])


@functools.partial(jax.jit, static_argnums=(1, 2))
def _mirror_im(keys, n_leaves, n_steps):
    keys, k_leaf = _split2(keys)
    leaf = jax.vmap(lambda k: jax.random.randint(k, (), 0, n_leaves))(k_leaf)

    def step(keys, _):
        keys, k_pick, k_u = jax.vmap(
            lambda k: tuple(jax.random.split(k, 3)))(keys)
        return keys, (jax.vmap(jax.random.bernoulli)(k_pick), _unif64(k_u))

    _, (rand_bit, u) = jax.lax.scan(step, keys, None, length=n_steps)
    return leaf, rand_bit, u


def im_sweep_draws(keys, n_leaves):
    leaf, rand_bit, u = _mirror_im(keys, n_leaves,
                                   tsb.max_walk_steps(n_leaves))
    return {'leaf': _t(leaf)[None], 'rand_bit': _t(rand_bit)[None],
            'u': _t(u)[None]}


def fw_sweep_draws(batch, cfg):
    """One FW sweep's float64 draws (``test_torch_batched_fw.fw_draws``
    in float64)."""
    n_bits = cfg.n_lanes * 32
    leaf, rand_bit, u, prio, u2, seen = _mirror(
        batch.keys, cfg.n_leaves, tsb.max_walk_steps(cfg.n_leaves), n_bits)
    steps = _walk_steps(np.asarray(batch.par), np.asarray(leaf))
    end = jnp.asarray(np.asarray(seen)[steps, np.arange(B)])
    _, k_res = _split2(end)
    jitter = jax.vmap(lambda k: jax.random.uniform(
        k, (n_bits,), dtype=F64))(k_res).T
    dr = {'leaf': leaf, 'rand_bit': rand_bit, 'u': u, 'jitter': jitter}
    if cfg.max_new_slices:
        dr.update(prio=prio, u2=u2)
    return {k: _t(v)[None] for k, v in dr.items()}


def _lockstep_setup(kind, seed, fw=False, mns=0):
    ts, out, dims = network(kind, seed)
    jt = trees(ts, out, dims, seed)
    t = jt[0]
    w = t.inds_array.shape[1]
    log2d = np.array(jbit.pad_log2_dims(t.log2_dims_array, w, F64))
    seeds = [seed + r for r in range(B)]
    ul = uniform_log2_dim(t.log2_dims_array)
    if ul is not None and not float(ul).is_integer():
        ul = None
    if fw:
        batch = jsfb.init_batch_fw(jt, seeds, MAX_WIDTH - 1.0, log2d,
                                   dtype=np.float64)
        flags = dict(n_leaves=t.n_leaves, n_lanes=w, max_new_slices=mns)
        return batch, SweepConfigFW(**flags), TConfigFW(**flags), log2d, ul
    batch = jsb.init_batch(jt, seeds, log2d, dtype=np.float64)
    flags = dict(n_leaves=t.n_leaves, n_lanes=w)
    return batch, SweepConfig(**flags), TConfig(**flags), log2d, ul


def _gap(ref, got):
    return max(float(np.max(np.abs(got[k] - np.asarray(getattr(ref, k)))))
               for k in ('log2_total', 'min_log2_total'))


@pytest.mark.parametrize('kind', ['lattice', 'mixed'])
def test_lockstep_im_sweep_float64(random_seed, kind):
    """One float64 'batched' IM sweep at a time, 4 sweeps, against the
    JAX lockstep engine under x64."""
    seed = random_seed % 1000
    batch, cfg, tcfg, log2d, ul = _lockstep_setup(kind, seed)
    assert batch.lcc.dtype == jnp.float64
    gaps = []
    for i, beta in enumerate(np.linspace(0.5, 8.0, 4)):
        dr = im_sweep_draws(batch.keys, cfg.n_leaves)
        ref, _ = jsb.run_sweeps_batched(batch, jnp.asarray([beta]),
                                        jnp.asarray(log2d).reshape(-1, 32),
                                        cfg, uniform_log2=ul)
        got, gm = tsb.run_sweeps_batched(
            batch_from_numpy(fields(batch), 'cpu'), [beta],
            _t(log2d).reshape(-1, 32), tcfg, uniform_log2=ul, draws=dr)
        assert got.lcc.dtype == torch.float64
        g = port_fields(got)
        min_ties(batch, ref, g)
        compare(fields(ref), g, f'{kind} sweep {i}', atol=TOTAL_ATOL64)
        gaps.append(_gap(ref, g))
        assert int(gm['moves'][0]) > 0
        batch = ref
    assert max(gaps) <= TOTAL_ATOL64


@pytest.mark.parametrize('kind,mns', [('lattice', 2), ('mixed', 0)])
def test_lockstep_fw_sweep_float64(random_seed, kind, mns):
    """One float64 'batched' FW sweep at a time with reslices (and the
    rescue where ``mns``), against JAX under x64 on the reference slicer
    (see :func:`test_walk_engines_float64`); on the lattice the port's
    popcount widths and plane slicer give the same sweep bitwise."""
    seed = random_seed % 1000
    batch, cfg, tcfg, log2d, ul = _lockstep_setup(kind, seed, fw=True,
                                                  mns=mns)
    w = cfg.n_lanes
    mw = MAX_WIDTH - 1.0
    skip = np.zeros(w, dtype=np.uint32)
    log2d_w32 = jnp.asarray(log2d).reshape(w, 32)
    for i, beta in enumerate(np.linspace(0.5, 8.0, 5)):
        upd = i % 2 == 0
        dr = fw_sweep_draws(batch, cfg)
        ref, _ = jsfb.run_sweeps_fw_batched(
            batch, jnp.asarray([beta]), jnp.asarray([upd]), jnp.float64(mw),
            log2d_w32, jnp.asarray(skip), cfg, uniform_log2=None)

        def port(ul_):
            return tsfb.run_sweeps_fw_batched(
                batch_fw_from_numpy(fields(batch), 'cpu'), [beta], [upd], mw,
                _t(log2d_w32), _t(skip.view(np.int32)), tcfg,
                uniform_log2=ul_, draws=dr)[0]

        got = port(None)
        assert got.width.dtype == torch.float64
        if ul is not None:
            compare(port_fields(got), port_fields(port(ul)),
                    f'{kind} sweep {i}: popcount vs pinned', atol=0)
        g = port_fields(got)
        reslice_ties(batch, ref, g, log2d_w32, None, cfg.n_leaves)
        min_ties(batch, ref, g)
        compare(fields(ref), g, f'{kind} mns={mns} sweep {i}',
                atol=TOTAL_ATOL64)
        batch = ref
    assert np.asarray(batch.slices).any()


@pytest.mark.parametrize('fw', [False, True])
def test_vmapped_sweep_float64(random_seed, fw):
    """One float64 'vmapped' sweep (replica-major states over the
    lockstep sweep) against the JAX vmapped engine under x64."""
    from test_torch_vmapped import jax_batch
    seed = random_seed % 1000
    batch, cfg, tcfg, log2d, ul = _lockstep_setup('lattice', seed, fw=fw)
    w = cfg.n_lanes
    if fw:
        states = jrep._to_vmapped_fw(batch)
        skip = np.zeros(w, dtype=np.uint32)
        dr = fw_sweep_draws(batch, cfg)
        ref, _ = jsaf.run_sweeps_fw_batch(
            states, jnp.asarray([2.0]), jnp.asarray([True]),
            jnp.float64(MAX_WIDTH - 1.0), jnp.asarray(log2d),
            jnp.asarray(skip), cfg)
        got, _ = tsaf.run_sweeps_fw_batch(
            tsaf.from_batch_fw(batch_fw_from_numpy(fields(batch), 'cpu')),
            [2.0], [True], MAX_WIDTH - 1.0, _t(log2d),
            _t(skip.view(np.int32)), tcfg, draws=dr)
        g = {k: v.copy() for k, v in
             batch_fw_to_numpy(tsaf.to_batch_fw(got)).items()}
        reslice_ties(batch, jax_batch(ref), g,
                     jnp.asarray(log2d).reshape(w, 32), None, cfg.n_leaves)
    else:
        states = jrep._to_vmapped(batch)
        dr = im_sweep_draws(batch.keys, cfg.n_leaves)
        ref, _ = jsa.run_sweeps_batch(states, jnp.asarray([2.0]),
                                      jnp.asarray(log2d), cfg)
        got, _ = tsa.run_sweeps_batch(
            tsa.from_batch(batch_from_numpy(fields(batch), 'cpu')), [2.0],
            _t(log2d), tcfg, uniform_log2=ul, draws=dr)
        g = port_fields(tsa.to_batch(got))
    assert got.lcc.dtype == torch.float64
    min_ties(batch, jax_batch(ref), g)
    compare(fields(jax_batch(ref)), g, f'vmapped fw={fw}', atol=TOTAL_ATOL64)


@pytest.mark.parametrize('engine', ['multiwalk', 'walks'])
@pytest.mark.parametrize('fw', [False, True])
def test_walk_engines_float64(random_seed, engine, fw):
    """One float64 iteration of the multi-walk and walks engines, IM and
    FW (with a reslice), from three JAX states in turn, against JAX under
    x64; the walks engine under 'chained' and 'dedup'.  Finite width
    runs the reference slicer (``uniform_log2=None``) on both sides: the
    JAX plane slicer fails under x64 (its window offsets mix int32 and
    int64, ``sa_finite_batched.py:241``); the port's plane slicer is then
    held bitwise to its reference one in float64."""
    batch, cfg, tcfg, log2d_w32, ul, _ = setup('dim2', random_seed % 1000,
                                               fw=fw, dtype=F64)
    assert batch.lcc.dtype == jnp.float64
    tlog2d = _t(log2d_w32)
    w = cfg.n_lanes
    p = 6
    opts = (dict(on_block='dedup', accept_rule='chained')
            if engine == 'walks' else {})
    pos = jnp.full((p, WB), -1, jnp.int32)
    for it, beta in enumerate((0.5, 3.0, 10.0)):
        wk, mw = jax_draws(batch.keys, cfg, p, F64, fw=fw)
        pos_t = _t(pos)
        jb = jnp.asarray([beta], F64)
        if fw:
            start = batch_fw_from_numpy(fields(batch), 'cpu')
            jargs = (jb, jnp.asarray([True]), jnp.float64(MAX_WIDTH),
                     jnp.asarray(log2d_w32), jnp.zeros(w, jnp.uint32), cfg)
            targs = ([beta], [True], MAX_WIDTH, tlog2d,
                     torch.zeros(w, dtype=torch.int32), tcfg)
            if engine == 'walks':
                ref, mref = jsw.run_walks_fw(batch, *jargs, pos,
                                             uniform_log2=None, **opts)

                def port(ul_):
                    return tsw.run_walks_fw(start, *targs, pos_t,
                                            uniform_log2=ul_, draws=wk,
                                            device='cpu', **opts)
            else:
                ref, mref = jsmw.run_multiwalk_fw(batch, *jargs, p, pos,
                                                  uniform_log2=None)

                def port(ul_):
                    return tsmw.run_multiwalk_fw(start, *targs, p, pos_t,
                                                 uniform_log2=ul_, draws=mw)
            got, mgot = port(None)
            plane, _ = port(ul)
            compare(port_fields(got), port_fields(plane),
                    f'{engine} iteration {it}: plane vs reference slicer',
                    atol=0)
        else:
            start = batch_from_numpy(fields(batch), 'cpu')
            if engine == 'walks':
                ref, mref = jsw.run_walks(batch, jb, jnp.asarray(log2d_w32),
                                          cfg, pos, uniform_log2=ul, **opts)
                got, mgot = tsw.run_walks(start, [beta], tlog2d, tcfg, pos_t,
                                          uniform_log2=ul, draws=wk,
                                          device='cpu', **opts)
            else:
                ref, mref = jsmw.run_multiwalk(batch, jb,
                                               jnp.asarray(log2d_w32), cfg,
                                               p, pos, uniform_log2=ul)
                got, mgot = tsmw.run_multiwalk(start, [beta], tlog2d, tcfg,
                                               p, pos_t, uniform_log2=ul,
                                               draws=mw)
        assert got.lcc.dtype == torch.float64
        g = port_fields(got)
        if fw:
            reslice_ties(batch, ref, g, jnp.asarray(log2d_w32), None,
                         cfg.n_leaves)
        min_ties(batch, ref, g)
        what = f'{engine} fw={fw} iteration {it}'
        compare(fields(ref), g, what, atol=TOTAL_ATOL64)
        np.testing.assert_array_equal(mgot['pos'].numpy(),
                                      np.asarray(mref['pos']), err_msg=what)
        assert int(mgot['applied']) == int(mref['applied']), what
        batch, pos = ref, mref['pos']


def _jitter64(seed, lanes, n_bits):
    """The JAX device kick's slicer jitter in float64
    (``test_torch_stall.jax_jitter``)."""
    words = np.asarray([(seed * 2654435761 + 7919 * lane) & 0xFFFFFFFF
                        for lane in lanes], dtype=np.uint32)
    keys0 = jnp.stack([jnp.zeros_like(jnp.asarray(words)),
                       jnp.asarray(words)], axis=1)
    k1 = jax.vmap(lambda k: jax.random.split(k)[1])(keys0)
    jit = jax.vmap(lambda k: jax.random.uniform(k, (n_bits,), dtype=F64))(k1)
    return torch.from_numpy(np.array(np.asarray(jit).T, order='C'))


@pytest.mark.parametrize('slicer', ['device', 'host'])
def test_float64_runner_exchange_and_kick(random_seed, slicer):
    """A float64 'walks' FW runner's exchange and kick against the JAX
    runner's on one state: exchange bitwise, the kick's integer and bit
    state bitwise and its totals within the float64 bound; then the
    runner's exchange cadence and a tempering ladder on it."""
    from test_torch_exchange import tree_pairs
    from tnco_tpu.optimize.finite_width import SimpleCostModel as JFWModel
    seed = random_seed % 1000
    jt, tt, _ = tree_pairs('mixed', seed)      # the reference slicer
    seeds = list(range(seed, seed + len(jt)))
    jr = jrep.ReplicaRunnerFW(jt, seeds, cmodel=JFWModel(max_width=6.0),
                              engine='walks', n_walks=4, dtype=F64)
    tr = trep.ReplicaRunnerFW(tt, seeds, cmodel=TFWModel(max_width=6.0),
                              engine='walks', n_walks=4, dtype=torch.float64,
                              device='cpu')
    jr.run(np.linspace(0, 8, 6), chunk_size=3, update_slices=3)
    tr.states = batch_fw_from_numpy(fields(jr.states), 'cpu')
    tr._mw_pos = torch.from_numpy(np.asarray(jr._mw_pos).copy())
    assert tr.states.lcc.dtype == torch.float64
    jx = jrep.exchange_best_fw(jr.states, 0.5, 2)
    tx = trep.exchange_best_fw(tr.states, 0.5, 2)
    compare(fields(jx), batch_fw_to_numpy(tx), 'exchange', atol=0)
    victims, src, kseed = [5, 1, 2], 0, 11 + seed
    jrep.kick_lanes_fw(jr, victims, src, seed=kseed, slicer=slicer)
    jitter = (_jitter64(kseed, sorted(set(victims)), tr.log2d_w32.numel())
              if slicer == 'device' else None)
    trep.kick_lanes_fw(tr, victims, src, seed=kseed, slicer=slicer,
                       jitter=jitter)
    assert tr.states.lcc.dtype == tr.states.log2_total.dtype == torch.float64
    compare(fields(jr.states), batch_fw_to_numpy(tr.states), f'kick {slicer}',
            atol=TOTAL_ATOL64 if slicer == 'device' else 0)
    tr.run(np.linspace(0, 8, 4), chunk_size=2, update_slices=2,
           exchange_every=1)
    # The tempering ladder: per-lane betas [n, B] on the float64 runner,
    # swaps on its float64 totals.
    from tnco_tpu_torch.parallel.tempering import TemperingLadder
    ladder = TemperingLadder(tr.n_replicas, beta_min=1.0, beta_max=8.0,
                             seed=seed)
    for _ in range(2):
        tr.run(ladder.betas_for(2), chunk_size=2, update_slices=2)
        ladder.swap(tr.states.log2_total.numpy())
    assert ladder.swaps_proposed > 0
    assert tr.states.log2_total.dtype == torch.float64
    for r in range(tr.n_replicas):
        assert tr.min_ctree(r).is_valid(check_shared_inds=True)


def test_walker_refuses_float64():
    """The walker holds one 32-bit lcc lane per row: a float64 runner or
    state raises a ``ValueError`` naming float32 (the JAX walker fails in
    its packing with a ``ValueError`` of its own)."""
    batch, cfg, tcfg, log2d_w32, ul, ttrees = setup('dim2', 7, dtype=F64)
    kw = dict(dtype=torch.float64, device='cpu')
    with pytest.raises(ValueError, match='float32'):
        trep.ReplicaRunner(ttrees, [1, 2, 3], engine='walker', **kw)
    with pytest.raises(ValueError, match='float32'):
        trep.ReplicaRunnerFW(ttrees, [1, 2, 3], engine='walker',
                             cmodel=TFWModel(max_width=MAX_WIDTH), **kw)
    pos = torch.full((4, WB), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match='float32'):
        tw.run_walker(batch_from_numpy(fields(batch), 'cpu'), [1.0],
                      _t(log2d_w32), tcfg, 4, pos,
                      generator=torch.Generator())
    from tnco_tpu.kernels import pallas_walker as jpw
    with pytest.raises(ValueError):
        jpw.run_walker(batch, jnp.asarray([1.0], F64),
                       jnp.asarray(log2d_w32), cfg, 4,
                       jnp.full((4, WB), -1, jnp.int32), interpret=True)
    # 'auto' keeps the JAX rule: a large dense network on the card still
    # resolves to the walker, which then refuses float64.
    assert trep.resolve_engine(4000, 16, accel=True, native=False,
                               sparse=False, max_new_slices=0,
                               disable_shared_inds=False, prob_kind=None,
                               fw=False) == 'walker'


def _capture(monkeypatch, module):
    """Records the runners an app module builds."""
    made = []
    cls = module.ReplicaRunnerFW if hasattr(module, 'ReplicaRunnerFW') \
        else module.ReplicaRunner

    def make(*a, **k):
        made.append(cls(*a, **k))
        return made[-1]

    monkeypatch.setattr(module, cls.__name__, make)
    return made


@pytest.mark.parametrize('fw', [False, True])
def test_optimizer_float64_end_to_end(monkeypatch, random_seed, fw):
    """``Optimizer(cost_type='float64')`` under the float64 mode runs its
    engine ('auto': 'batched') in float64: every device log2 min total
    within 1e-9 of the exact bigint cost of its tree; outside the mode
    the same call runs float32."""
    from benchmarks.networks import lattice_2d
    from tnco_tpu_torch.app import Optimizer
    from tnco_tpu_torch.app.finite_width import sa as fw_sa
    from tnco_tpu_torch.app.infinite_memory import sa as im_sa
    from tnco_tpu_torch.app.tn import Tensor, TensorNetwork
    ts, out, dims = lattice_2d(4, 5)
    tn = TensorNetwork([Tensor(xs, tuple(dims[x] for x in xs))
                        for xs in ts], output_inds=out)
    made = _capture(monkeypatch, fw_sa if fw else im_sa)
    kw = dict(max_width=4) if fw else {}
    for mode in (True, False):
        with tbit.enable_float64(mode):
            opt = Optimizer(seed=random_seed % 1000, device='cpu',
                            cost_type='float64', **kw)
            _, res = opt.optimize(tn, betas=(0, 10), n_steps=8, n_runs=3,
                                  fuse=0)
        runner = made[-1]
        assert runner.engine == 'batched'
        assert runner.states.lcc.dtype == (torch.float64 if mode else
                                           torch.float32)
        assert len(res) == 3
        if not mode:
            continue
        mins = runner.log2_min_totals()
        assert mins.dtype == np.float64
        assert abs(math.log2(int(res[0].cost)) - float(mins.min())) <= 1e-9
        for r in range(runner.n_replicas if not fw else 0):
            exact = math.log2(int(runner.min_ctree(r).total_cost_exact()))
            assert abs(exact - float(mins[r])) <= 1e-9


def _opt_tree(rng, random_seed):
    from tnco_tpu.testing.utils import generate_random_tensors
    from tnco_tpu_torch.ctree import ContractionTree as TTree
    from tnco_tpu_torch.utils.tn import get_random_contraction_path
    ts_inds, output_inds, dims = generate_random_tensors(rng,
                                                         n_output_inds=2)
    (path,) = [p for p in get_random_contraction_path(
        ts_inds, output_inds, merge_paths=False, seed=random_seed) if p]
    return TTree(path, ts_inds, dims, output_inds=output_inds,
                 check_shared_inds=True)


def test_im_optimizer_float64(rng, random_seed):
    """The counterpart of ``test_float64.test_im_optimizer_float64``: the
    single IM optimizer under the float64 mode keeps float64 state, and
    its log2 min total is within 1e-9 of the exact bigint cost."""
    from tnco_tpu_torch.optimize.infinite_memory import (Optimizer,
                                                         SimpleCostModel)
    from tnco_tpu_torch.optimize.prob import MetropolisHastings

    with tbit.enable_float64():
        opt = Optimizer(_opt_tree(rng, random_seed),
                        SimpleCostModel(cost_type='float64'),
                        seed=random_seed, device='cpu')
        assert opt._state.lcc.dtype == torch.float64
        prob = MetropolisHastings(beta=1.0)
        for _ in range(10):
            opt.update(prob)
        ok, msg = opt.is_valid(return_message=True)
        assert ok, msg
        assert opt.log2_min_total_cost == pytest.approx(
            math.log2(int(opt.min_total_cost)), abs=1e-9)


def test_fw_optimizer_float64(rng, random_seed):
    """The counterpart of ``test_float64.test_fw_optimizer_float64``."""
    from tnco_tpu_torch.optimize.finite_width import (Optimizer,
                                                      SimpleCostModel)
    from tnco_tpu_torch.optimize.prob import MetropolisHastings

    with tbit.enable_float64():
        opt = Optimizer(_opt_tree(rng, random_seed),
                        SimpleCostModel(max_width=3.0, cost_type='float64'),
                        seed=random_seed, device='cpu')
        assert opt._state.lcc.dtype == torch.float64
        prob = MetropolisHastings(beta=1.0)
        for i in range(10):
            opt.update(prob, update_slices=(i % 3 == 0))
        ok, msg = opt.is_valid(return_message=True)
        assert ok, msg
        assert opt.log2_min_total_cost == pytest.approx(
            math.log2(int(opt.min_total_cost)), abs=1e-9)

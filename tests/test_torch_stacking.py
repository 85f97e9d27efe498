"""The reference's last public names in the port, against the JAX package:
the batch stacking helpers (``sa_batched.from_states``/``replica_state``,
``sa_finite_batched.from_states_fw``/``replica_state_fw``), the batch
builders' device rule, the sampler's ``optimization_backend`` and the
kernel wrappers' parameter names.

The engine tests are the port's counterparts of
``tests/test_sa_batched.py::test_batched_matches_vmapped`` and
``tests/test_sa_finite_batched.py::test_fw_batched_matches_vmapped``:
one stacked batch, the lockstep engine and the 'vmapped' one on the same
draws (the JAX draws, mirrored from the replicas' threefry keys, as
``test_torch_batched`` does), bitwise equal to each other; each sweep
held against the JAX lockstep engine from the JAX state (integer and bit
state bitwise, totals within 1e-5 in log2, float ties of the min
snapshot settled by ``test_torch_batched.min_ties``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tnco_tpu.app.circuit import Sampler as JSampler
from tnco_tpu.ctree import ContractionTree as JTree
from tnco_tpu.kernels import pallas_gather as jpg
from tnco_tpu.kernels import pallas_scatter as jps
from tnco_tpu.kernels import sa_batched as jsb
from tnco_tpu.kernels import sa_finite as jsaf
from tnco_tpu.kernels import sa_finite_batched as jsfb
from tnco_tpu.kernels import sa_infinite as jsa
from tnco_tpu.ops import bitops as jbit
from tnco_tpu.testing.utils import generate_random_tensors
from tnco_tpu.utils.tn import get_random_contraction_path
from tnco_tpu_torch.app.circuit import Sampler, sample
from tnco_tpu_torch.convert import batch_fw_to_numpy, batch_to_numpy
from tnco_tpu_torch.ctree import ContractionTree as TTree
from tnco_tpu_torch.kernels import gather as tg
from tnco_tpu_torch.kernels import sa_batched as tsb
from tnco_tpu_torch.kernels import sa_finite as tsaf
from tnco_tpu_torch.kernels import sa_finite_batched as tsfb
from tnco_tpu_torch.kernels import sa_infinite as tsa
from tnco_tpu_torch.kernels import scatter as tsc
from tnco_tpu_torch.testing.networks import qaoa_sampling_circuit
from test_torch_batched import (TOTAL_ATOL, Margins, compare, fields,
                                min_ties, network, sweep_draws)
from test_torch_batched_fw import fw_draws
from test_torch_sparse import MAX_WIDTH
from torch_reference_native import reference_native  # noqa: F401

_TOTALS = ('log2_total', 'min_log2_total')


def _t(x):
    return torch.from_numpy(np.array(x, order='C'))


def _pair_trees(ts, out, dims, seed, n):
    """One random path a replica (seeds ``seed + r``), as JAX and as port
    trees."""
    order = tuple(dict.fromkeys(x for xs in ts for x in xs))
    jt, tt = [], []
    for r in range(n):
        (path,) = [p for p in get_random_contraction_path(
            ts, out, merge_paths=False, seed=seed + r) if p]
        for cls, dst in ((JTree, jt), (TTree, tt)):
            dst.append(cls(path, ts, dims, output_inds=out,
                           check_shared_inds=True, inds_order=order))
    return jt, tt


def _random_trees(rng, random_seed, n, **kw):
    """The reference tests' set-up: a random network with two output
    indices, one random path a replica."""
    ts, out, dims = generate_random_tensors(rng, n_output_inds=2, **kw)
    return _pair_trees(ts, out, dims, random_seed, n)


def _log2d(jt):
    t = jt[0]
    return np.array(jbit.pad_log2_dims(t.log2_dims_array,
                                       t.inds_array.shape[1]))


def _jitter(seed, n_bits):
    """The slicer's jitter of the JAX ``init_state_fw``: uniform from
    ``split(PRNGKey(seed))[1]``."""
    key = jax.random.split(jax.random.PRNGKey(seed))[1]
    return _t(jax.random.uniform(key, (n_bits,), dtype=jnp.float32))


def _states(jt, tt, seed0, max_width=None):
    """JAX and port single-replica states of the trees (seeds ``seed0 +
    r``), IM, or FW at ``max_width``."""
    log2d = _log2d(jt)
    js, ts = [], []
    for r, (j, t) in enumerate(zip(jt, tt)):
        seed = seed0 + r
        if max_width is None:
            js.append(jsa.init_state(j, seed, jnp.asarray(log2d)))
            ts.append(tsa.init_state(t, seed, _t(log2d), device='cpu'))
        else:
            js.append(jsaf.init_state_fw(j, seed, max_width,
                                         jnp.asarray(log2d)))
            ts.append(tsaf.init_state_fw(t, seed, max_width, _t(log2d),
                                         jitter=_jitter(seed, log2d.size),
                                         device='cpu'))
    return js, ts, log2d


def _equal(a, b, what):
    """Two states (or two batches) equal bitwise in every field."""
    for k in type(a).field_names():
        assert torch.equal(getattr(a, k), getattr(b, k)), f'{what}: {k}'


@pytest.mark.parametrize('hyper', [False, True])
@pytest.mark.parametrize('prob_kind', ['mh', 'greedy'])
def test_batched_matches_vmapped(monkeypatch, prob_kind, hyper, rng,
                                 random_seed):
    """``from_states`` of the replicas' states, then 8 sweeps over a beta
    ramp: the lockstep ``run_sweeps_batched`` and the 'vmapped'
    ``run_sweeps_batch`` of the port equal each other bitwise on the same
    draws (moves too), and the JAX lockstep engine sweep by sweep;
    ``replica_state`` of the result equals the vmapped state's replica
    and the JAX ``replica_state``."""
    seed = random_seed % 1000
    kw = dict(n_hyper_edges=2, n_hyper_output_inds=1) if hyper else {}
    jt, tt = _random_trees(rng, seed, 5, **kw)
    jstates, tstates, log2d = _states(jt, tt, seed)
    w = log2d.size // 32
    flags = dict(n_leaves=jt[0].n_leaves, n_lanes=w, prob_kind=prob_kind)
    cfg, tcfg = jsa.SweepConfig(**flags), tsa.SweepConfig(**flags)
    log2d_w32 = log2d.reshape(w, 32)
    jb = jsb.from_states(jstates)
    tb = tsb.from_states(tstates)
    compare(jb, batch_to_numpy(tb), 'from_states', skip=())
    stacked = tsa.stack(tstates)
    moves = 0
    for i, beta in enumerate(np.linspace(0.0, 15.0, 8, dtype=np.float32)):
        margins = Margins(monkeypatch)
        dr = sweep_draws(jb.keys, cfg.n_leaves)
        ref, rm = jsb.run_sweeps_batched(jb, jnp.asarray([beta]),
                                         jnp.asarray(log2d_w32), cfg)
        lock, lm = tsb.run_sweeps_batched(tb, [beta], _t(log2d_w32), tcfg,
                                          draws=dr)
        vm, vmm = tsa.run_sweeps_batch(stacked, [beta], _t(log2d), tcfg,
                                       draws=dr)
        what = f'{prob_kind} hyper={hyper} sweep {i}'
        _equal(tsa.to_batch(vm), lock, what)
        assert int(vmm['moves'].sum()) == int(lm['moves'].sum()), what
        g = batch_to_numpy(lock)
        min_ties(jb, ref, g)
        compare(ref, g, what, margins)
        assert int(lm['moves'][0]) == int(rm['moves'][0]), what
        moves += int(lm['moves'][0])
        jb, tb, stacked = ref, lock, vm
    assert moves > 0
    for r in range(len(tt)):
        got = tsb.replica_state(tb, r)
        _equal(got, tsa.unstack(stacked, r), f'replica {r}')
        want = jsb.replica_state(jb, r)
        np.testing.assert_array_equal(got.nodes.numpy(),
                                      np.asarray(want.nodes))
        np.testing.assert_array_equal(got.hyper.numpy().view(np.uint32),
                                      np.asarray(want.hyper))


@pytest.mark.parametrize('max_width', [2.5, 4.0])
def test_fw_batched_matches_vmapped(monkeypatch, max_width, rng,
                                    random_seed):
    """The finite-width counterpart: ``from_states_fw``, 8 sweeps
    (reslices after sweeps 0, 3 and 6), the lockstep
    ``run_sweeps_fw_batched`` and the 'vmapped' ``run_sweeps_fw_batch``
    bitwise equal on the same draws, and the JAX lockstep engine sweep by
    sweep; ``replica_state_fw`` of the result equals the vmapped state's
    replica and the JAX ``replica_state_fw``."""
    seed = random_seed % 1000
    jt, tt = _random_trees(rng, seed, 4)
    jstates, tstates, log2d = _states(jt, tt, seed, max_width)
    w = log2d.size // 32
    flags = dict(n_leaves=jt[0].n_leaves, n_lanes=w)
    cfg, tcfg = jsaf.SweepConfigFW(**flags), tsaf.SweepConfigFW(**flags)
    log2d_w32 = log2d.reshape(w, 32)
    skip = np.zeros(w, dtype=np.uint32)
    tskip = _t(skip.view(np.int32))
    jb = jsfb.from_states_fw(jstates)
    tb = tsfb.from_states_fw(tstates)
    compare(jb, batch_fw_to_numpy(tb), 'from_states_fw')
    stacked = tsa.stack(tstates)
    moves = 0
    for i, beta in enumerate(np.linspace(0.0, 15.0, 8, dtype=np.float32)):
        upd = i % 3 == 0
        margins = Margins(monkeypatch)
        dr, _ = fw_draws(jb, cfg)
        ref, rm = jsfb.run_sweeps_fw_batched(
            jb, jnp.asarray([beta]), jnp.asarray([upd]),
            jnp.float32(max_width), jnp.asarray(log2d_w32),
            jnp.asarray(skip), cfg)
        lock, lm = tsfb.run_sweeps_fw_batched(
            tb, [beta], [upd], max_width, _t(log2d_w32), tskip, tcfg,
            draws=dr)
        vm, vmm = tsaf.run_sweeps_fw_batch(
            stacked, [beta], [upd], max_width, _t(log2d), tskip, tcfg,
            draws=dr)
        what = f'max_width {max_width} sweep {i}'
        _equal(tsaf.to_batch_fw(vm), lock, what)
        assert int(vmm['moves'].sum()) == int(lm['moves'].sum()), what
        g = batch_fw_to_numpy(lock)
        min_ties(jb, ref, g)
        compare(ref, g, what, margins)
        assert int(lm['moves'][0]) == int(rm['moves'][0]), what
        moves += int(lm['moves'][0])
        jb, tb, stacked = ref, lock, vm
    assert moves > 0
    for r in range(len(tt)):
        got = tsfb.replica_state_fw(tb, r)
        _equal(got, tsa.unstack(stacked, r), f'replica {r}')
        want = jsfb.replica_state_fw(jb, r)
        for k in ('nodes', 'width', 'slices', 'min_slices'):
            g = getattr(got, k).numpy()
            w_ = np.asarray(getattr(want, k))
            np.testing.assert_array_equal(
                g.view(w_.dtype) if g.dtype.itemsize == w_.dtype.itemsize
                else g, w_, err_msg=k)


@pytest.mark.parametrize('fw', [False, True], ids=['im', 'fw'])
@pytest.mark.parametrize('kind', ['lattice', 'mixed', 'hyper'])
def test_from_states_matches_jax(random_seed, kind, fw):
    """``from_states(_fw)`` of the port's ``init_state(_fw)`` against the
    JAX ``from_states(_fw)`` of the JAX states, field by field through
    ``convert.py``: integer and bit fields bitwise (the FW ``keys`` are
    the port's seed words); the totals, which each side's ``init_state``
    computes with its own ``exp2``/``log2``, within 1e-5 in log2.  The
    batch lands on the states' device."""
    seed = random_seed % 1000
    jt, tt = _pair_trees(*network(kind, seed), seed, 4)
    mw = MAX_WIDTH[kind] if fw else None
    jstates, tstates, _ = _states(jt, tt, seed, mw)
    if fw:
        want = fields(jsfb.from_states_fw(jstates))
        batch = tsfb.from_states_fw(tstates)
        got = batch_fw_to_numpy(batch)
        assert want['slices'].any()
    else:
        want = fields(jsb.from_states(jstates))
        batch = tsb.from_states(tstates)
        got = batch_to_numpy(batch)
    assert got.keys() == want.keys()
    # The JAX FW state carries the key its slicer split off; the port's
    # carries the seed words [0, seed] (ROADMAP queue 3: 'vmapped' keys).
    np.testing.assert_array_equal(
        got['keys'], [[0, seed + r] for r in range(len(tt))])
    for k, v in want.items():
        if k == 'keys' and fw:
            continue
        if k in _TOTALS:
            np.testing.assert_allclose(got[k], v, rtol=0, atol=TOTAL_ATOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert {getattr(batch, k).device.type
            for k in type(batch).field_names()} == {'cpu'}


@pytest.mark.parametrize('fw', [False, True], ids=['im', 'fw'])
def test_replica_state_round_trips(random_seed, fw):
    """``replica_state(_fw)`` of a batch built by ``init_batch(_fw)``
    equals the replica's column bitwise (through ``from_batch(_fw)``),
    and ``from_states(_fw)`` of every replica gives the batch back."""
    seed = random_seed % 1000
    jt, tt = _pair_trees(*network('lattice', seed), seed, 4)
    log2d = _log2d(jt)
    seeds = [seed + r for r in range(len(tt))]
    if fw:
        batch = tsfb.init_batch_fw(tt, seeds, MAX_WIDTH['lattice'], log2d,
                                   device='cpu')
        stacked = tsaf.from_batch_fw(batch)
        pick, join = tsfb.replica_state_fw, tsfb.from_states_fw
    else:
        batch = tsb.init_batch(tt, seeds, log2d, device='cpu')
        stacked = tsa.from_batch(batch)
        pick, join = tsb.replica_state, tsb.from_states
    states = [pick(batch, r) for r in range(len(tt))]
    for r, s in enumerate(states):
        _equal(s, tsa.unstack(stacked, r), f'replica {r}')
        assert s.nodes.shape == (len(tt[0]), 3)
        assert int(s.key[1]) == seeds[r]
    _equal(join(states), batch, 'round trip')


@pytest.mark.parametrize('fw', [False, True], ids=['im', 'fw'])
def test_states_on_two_devices_raise(fw):
    """A batch of states on two devices raises, as does no state at all.
    The second device is the card where there is one, else PyTorch's
    'meta' device (tensors without data)."""
    _, tt = _pair_trees(*network('lattice', 0), 0, 2)
    other = 'cuda' if torch.cuda.is_available() else 'meta'
    if fw:
        states = [tsaf.init_state_fw(t, r, 4.0, device='cpu')
                  for r, t in enumerate(tt)]
        join = tsfb.from_states_fw
    else:
        states = [tsa.init_state(t, r, device='cpu')
                  for r, t in enumerate(tt)]
        join = tsb.from_states
    cls = type(states[0])
    moved = cls(**{k: getattr(states[1], k).to(other)
                   for k in cls.field_names()})
    with pytest.raises(ValueError, match='several devices'):
        join([states[0], moved])
    with pytest.raises(ValueError, match='at least one'):
        join([])


def test_batch_builders_follow_the_device_rule(monkeypatch):
    """``init_batch`` and ``init_batch_fw`` without ``device`` mean the
    card: without CUDA they raise the device rule's ``RuntimeError``
    before any host work; ``device='cpu'`` builds on the host."""
    jt, tt = _pair_trees(*network('lattice', 0), 0, 2)
    log2d = _log2d(jt)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for build in (lambda **kw: tsb.init_batch(tt, [0, 1], log2d, **kw),
                  lambda **kw: tsfb.init_batch_fw(tt, [0, 1], 4.0, log2d,
                                                  **kw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build(device='cuda')
        assert build(device='cpu').c0.device.type == 'cpu'


def test_sampler_optimization_backend():
    """``Sampler(optimization_backend=...)`` passes it to its optimizer
    as ``backend``, as the JAX sampler does, and samples the bitstrings
    of ``Sampler()`` with the same seed; ``sample()`` takes it as a named
    keyword and does not hand it to ``optimize``."""
    gates = qaoa_sampling_circuit(4, 2, 0)
    order = tuple(range(4))
    opt = dict(betas=(0, 20), n_steps=4, n_runs=1)
    want = JSampler(optimization_backend='numpy', seed=3)
    assert want._optimizer.backend == 'numpy'
    sampler = Sampler(optimization_backend='numpy', seed=3, device='cpu')
    assert sampler.optimization_backend == 'numpy'
    assert sampler._optimizer.backend == 'numpy'
    plain = Sampler(seed=3, device='cpu')
    assert plain._optimizer.backend is None
    hits = sampler.sample(gates, n_samples=40, qubit_order=order,
                          normalize=False, **opt)
    assert hits == plain.sample(gates, n_samples=40, qubit_order=order,
                                normalize=False, **opt)
    assert sum(hits[0].values()) == 40 and len(hits[0]) > 1
    state = plain.sample(gates, return_intermediate_state_only=True, **opt)
    got = sample(state, None, n_samples=20, qubit_order=order, seed=5,
                 optimization_backend='numpy')
    assert got == sample(state, None, n_samples=20, qubit_order=order,
                         seed=5)


def test_kernel_wrappers_take_the_reference_keywords():
    """The five kernel wrappers and their plain versions take the JAX
    wrappers' parameter names (``vals_gbn``, ``vals_bn``, ``ids_bq``,
    ``upd_gbq``) as keywords, with the JAX wrappers' results."""
    gen = np.random.default_rng(7)
    g, b, n, q = 5, 3, 40, 9
    vals = gen.integers(-2**31, 2**31, (g, b, n), dtype=np.int64).astype(
        np.int32)
    ids = gen.integers(-1, n + 3, (b, q)).astype(np.int32)
    upd = gen.integers(-2**31, 2**31, (2, b, q), dtype=np.int64).astype(
        np.int32)
    tv, ti, tu = _t(vals), _t(ids), _t(upd)
    jv, ji, ju = jnp.asarray(vals), jnp.asarray(ids), jnp.asarray(upd)
    for fn in (tg.gather_gbn, tg.gather_plain):
        got = fn(vals_gbn=tv, ids_bq=ti, planes=(1, 3))
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jpg.gather_gbn(vals_gbn=jv, ids_bq=ji, planes=(1, 3))))
    np.testing.assert_array_equal(
        tg.gather_bn(vals_bn=tv[0], ids_bq=ti).numpy(),
        np.asarray(jpg.gather_bn(vals_bn=jv[0], ids_bq=ji)))
    for fn in (tsc.inv_ids, tsc.inv_ids_plain):
        np.testing.assert_array_equal(fn(ids_bq=ti, n=n).numpy(), np.asarray(
            jps.inv_ids(ids_bq=ji, n=n)))
    want = np.asarray(jps.scatter_rows_gbn(vals_gbn=jv, ids_bq=ji,
                                           upd_gbq=ju, planes=(2, 4)))
    for fn in (tsc.scatter_rows_gbn, tsc.scatter_rows_gbn_plain):
        got = fn(vals_gbn=tv, ids_bq=ti, upd_gbq=tu, planes=(2, 4))
        np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jps.scatter_rows_inplace(vals_gbn=jv, ids_bq=ji,
                                               upd_gbq=ju, planes=(2, 4)))
    for fn in (tsc.scatter_rows_inplace, tsc.scatter_rows_inplace_plain):
        out = tv.clone()
        assert fn(vals_gbn=out, ids_bq=ti, upd_gbq=tu,
                  planes=(2, 4)) is out
        np.testing.assert_array_equal(out.numpy(), want)

"""The port's slice-kick (``kick_lanes_fw``) and its stall watchdog
(``IslandStallKicker``) vs the JAX package's.

Both runners hold one state (the JAX runner's, carried across after a
few chunks).  ``slicer='host'`` must equal the JAX kick bitwise in every
field but ``keys`` (the port keeps seed words where the JAX package keeps
threefry keys).  ``slicer='device'`` gets the JAX slicer's jitter
(``split(PRNGKey-like([0, seed']))[1]`` per victim): integer and bit
state bitwise, totals within 1e-5 in log2 (PERF.md "Float bound").
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tnco_tpu.parallel import replicas as jrep
from tnco_tpu.parallel.stall import IslandStallKicker as JKicker
from tnco_tpu_torch.bitset import Bitset
from tnco_tpu_torch.convert import batch_fw_to_numpy
from tnco_tpu_torch.optimize.finite_width import SimpleCostModel as TFWModel
from tnco_tpu_torch.parallel import replicas as trep
from tnco_tpu_torch.parallel import stall as tstall
from tnco_tpu_torch.parallel.stall import IslandStallKicker
from test_torch_exchange import B, MAX_WIDTH, fields, fw_runners, sync_fw
from torch_reference_native import reference_native  # noqa: F401

TOTAL_ATOL = 1e-5
_TOTALS = ('log2_total', 'min_log2_total')
_KINDS = ['stall', 'lattice', 'mixed']


def _warm(kind, seed):
    """JAX and port runners ('walks', P=4) on one state after two JAX
    chunks of 5 iterations (reslice every 5)."""
    jr, tr, net = fw_runners(kind, seed)
    jr.run(np.linspace(0, 8, 10).astype(np.float32), chunk_size=5,
           update_slices=5)
    sync_fw(jr, tr)
    return jr, tr, net


def jax_jitter(seed, lanes, n_bits):
    """The JAX device kick's slicer jitter for ``lanes`` (sorted),
    ``float32 [n_bits, K]``: ``uniform(split([0, seed'])[1])`` with
    ``seed' = (seed * 2654435761 + 7919 * lane) & 0xFFFFFFFF``."""
    words = np.asarray([(seed * 2654435761 + 7919 * lane) & 0xFFFFFFFF
                        for lane in lanes], dtype=np.uint32)
    keys0 = jnp.stack([jnp.zeros_like(jnp.asarray(words)),
                       jnp.asarray(words)], axis=1)
    k1 = jax.vmap(lambda k: jax.random.split(k)[1])(keys0)
    jit = jax.vmap(lambda k: jax.random.uniform(k, (n_bits,),
                                                dtype=jnp.float32))(k1)
    return torch.from_numpy(np.array(np.asarray(jit).T, order='C'))


def _compare(jr, tr, what, exact_totals):
    want, got = fields(jr.states), batch_fw_to_numpy(tr.states)
    for k, v in want.items():
        if k == 'keys':
            continue
        if k in _TOTALS and not exact_totals:
            np.testing.assert_allclose(got[k], v, rtol=0, atol=TOTAL_ATOL,
                                       err_msg=f'{what}: {k}')
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=f'{what}: {k}')
    np.testing.assert_array_equal(tr._mw_pos.numpy(), np.asarray(jr._mw_pos),
                                  err_msg=f'{what}: walk positions')


@pytest.mark.parametrize('slicer', ['host', 'device'])
@pytest.mark.parametrize('kind', _KINDS)
def test_kick_matches_jax(random_seed, kind, slicer):
    seed = random_seed % 1000
    jr, tr, _ = _warm(kind, seed)
    victims, src, kseed = [6, 2, 3, 6], 1, 7 + seed
    jrep.kick_lanes_fw(jr, victims, src, seed=kseed, slicer=slicer)
    jitter = (jax_jitter(kseed, sorted(set(victims)), tr.log2d_w32.numel())
              if slicer == 'device' else None)
    trep.kick_lanes_fw(tr, victims, src, seed=kseed, slicer=slicer,
                       jitter=jitter)
    _compare(jr, tr, f'{kind} {slicer}', exact_totals=slicer == 'host')
    keys = tr.states.keys.numpy().view(np.uint32)
    for v in (2, 3, 6):
        assert keys[v].tolist() == [
            0, (kseed * 2654435761 + 7919 * v) & 0xFFFFFFFF]


def _exact_log2(tree, lanes, order, max_width):
    labels = frozenset(order[p] for p in Bitset.from_lanes(
        lanes, len(order)).positions())
    cm = TFWModel(max_width=max_width)
    return math.log2(sum(
        cm.contraction_cost(tree.inds[n.children[0]],
                            tree.inds[n.children[1]], tree.inds[p],
                            tree.dims, labels)
        for p, n in enumerate(tree.nodes) if not n.is_leaf()))


@pytest.mark.parametrize('slicer', ['device', 'host'])
def test_kick_lanes_fw(random_seed, slicer):
    """The port of ``test_stall.test_kick_lanes_fw`` on the port alone:
    victims carry the source tree, fresh valid slices and fresh keys;
    others and every min snapshot are bitwise untouched; walk positions
    restart; each victim's written total is the exact cost of its (tree,
    slices); the engine takes the kicked state."""
    seed = random_seed % 1000
    _, runner, (ts, out, dims, order) = fw_runners('stall', seed)
    betas = np.linspace(0, 8, 20).astype(np.float32)
    runner.run(betas, chunk_size=10, update_slices=5)
    before = batch_fw_to_numpy(runner.states)
    pos_before = runner._mw_pos.clone()
    victims, src = [2, 3, 6], 1
    trep.kick_lanes_fw(runner, victims, src, seed=7, slicer=slicer)
    after = batch_fw_to_numpy(runner.states)

    untouched = [i for i in range(B) if i not in victims]
    for name in after:
        sel = np.s_[untouched] if name == 'keys' else np.s_[..., untouched]
        np.testing.assert_array_equal(before[name][sel], after[name][sel],
                                      err_msg=f'{name} non-victim')
    for name in ('min_c0', 'min_c1', 'min_par', 'min_inds', 'min_slices',
                 'min_log2_total'):
        np.testing.assert_array_equal(before[name], after[name])
    for v in victims:
        for name in ('c0', 'c1', 'par', 'inds', 'hyper', 'width'):
            np.testing.assert_array_equal(after[name][..., v],
                                          before[name][..., src],
                                          err_msg=f'{name} victim {v}')
        assert not np.array_equal(after['keys'][v], before['keys'][v])
        tree = runner.ctree(v)
        assert tree.is_valid(check_shared_inds=True)
        exact = _exact_log2(tree, runner.slices_lanes(v), order,
                            MAX_WIDTH['stall'])
        assert float(after['log2_total'][v]) == pytest.approx(exact,
                                                              abs=1e-3)
    assert (runner._mw_pos[:, victims] == -1).all()
    assert torch.equal(runner._mw_pos[:, untouched],
                       pos_before[:, untouched])

    runner.run(betas, chunk_size=10, update_slices=5)
    idx = int(np.argmin(runner.log2_min_totals()))
    assert runner.min_ctree(idx).is_valid(check_shared_inds=True)


def test_kick_options_raise(random_seed):
    _, runner, _ = fw_runners('lattice', random_seed % 1000)
    with pytest.raises(ValueError, match='slicer'):
        trep.kick_lanes_fw(runner, [1], 0, seed=1, slicer='plane')
    with pytest.raises(ValueError, match='jitter'):
        trep.kick_lanes_fw(runner, [1, 2], 0, seed=1,
                           jitter=torch.zeros(3, 2))
    runner.engine = 'vmapped'
    with pytest.raises(ValueError, match='lane-major'):
        trep.kick_lanes_fw(runner, [1], 0, seed=1)


def test_island_stall_kicker(random_seed):
    """The port of ``test_stall.test_island_stall_kicker``: fires after
    the window, respects the cooldown and the budget-fraction guard,
    suspends exchange, preserves the mins."""
    _, runner, _ = fw_runners('stall', random_seed % 1000)
    runner.run(np.linspace(0, 4, 10).astype(np.float32), chunk_size=10,
               update_slices=5)
    mins0 = runner.log2_min_totals().copy()
    kicker = IslandStallKicker(runner, islands=2, window_chunks=2,
                               min_delta=1e9, cooldown_chunks=4,
                               keep_top=1, exchange_skip_chunks=3,
                               frac_guard=0.9, seed=3)
    assert kicker.observe(1, 0.1) == []          # baseline mark
    assert kicker.observe(2, 0.1) == []          # window not yet hit
    assert kicker.observe(3, 0.1) == [0, 1]      # both islands stalled
    assert kicker.observe(4, 0.1) == []          # cooldown
    assert not kicker.exchange_active(4).any()   # exchange suspended
    assert kicker.exchange_active(6).all()
    assert kicker.observe(8, 0.95) == []         # frac guard
    assert kicker.observe(8, 0.1) == [0, 1]      # re-armed
    assert len(kicker.kicks) == 4
    np.testing.assert_array_equal(runner.log2_min_totals(), mins0)
    with pytest.raises(ValueError, match='divide'):
        IslandStallKicker(runner, islands=3)


def _recorder(fn, calls, inject=None):
    def kick(runner, lanes, src, seed, **kw):
        lanes = sorted(set(int(x) for x in lanes))
        calls.append((lanes, int(src), int(seed)))
        if inject is not None:
            kw['jitter'] = inject(seed, lanes, runner.log2d_w32.numel())
        return fn(runner, lanes, src, seed, **kw)
    return kick


@pytest.mark.parametrize('kind', ['stall', 'lattice'])
def test_kicker_decisions_match_jax(monkeypatch, random_seed, kind):
    """One ``observe`` sequence on both packages from one state: the same
    islands kicked at each observation, the same ``kicks`` records, the
    same (victims, source, seed) calls, and after each kick the same
    state (the port's device slicer fed the JAX jitter)."""
    seed = random_seed % 1000
    jr, tr, _ = _warm(kind, seed)
    jcalls, tcalls = [], []
    monkeypatch.setattr(jrep, 'kick_lanes_fw',
                        _recorder(jrep.kick_lanes_fw, jcalls))
    monkeypatch.setattr(tstall, 'kick_lanes_fw',
                        _recorder(trep.kick_lanes_fw, tcalls, jax_jitter))
    kw = dict(islands=4, window_chunks=2, min_delta=10.0, cooldown_chunks=3,
              exchange_skip_chunks=2, seed=5)
    jk, tk = JKicker(jr, **kw), IslandStallKicker(tr, **kw)
    for chunk, frac in ((1, 0.1), (2, 0.2), (3, 0.3), (4, 0.4), (5, 0.5),
                        (6, 0.6), (7, 0.9), (8, 0.7)):
        want = jk.observe(chunk, frac)
        assert tk.observe(chunk, frac) == want, chunk
        np.testing.assert_array_equal(tk.exchange_active(chunk),
                                      jk.exchange_active(chunk))
        _compare(jr, tr, f'chunk {chunk}', exact_totals=False)
    assert tcalls == jcalls and len(jcalls) == 8
    assert tk.kicks == jk.kicks


@pytest.mark.cuda
@pytest.mark.parametrize('slicer', ['host', 'device'])
@pytest.mark.parametrize('kind', ['stall', 'lattice'])
def test_card_kick_matches_cpu(random_seed, kind, slicer):
    """The card against the CPU on one kick from one state (the device
    slicer fed the same jitter): integer and bit state bitwise, totals
    within 1e-5 (bitwise with the host slicer)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    seed = random_seed % 1000
    _, cpu, _ = _warm(kind, seed)
    card = trep.ReplicaRunnerFW(
        [cpu.template] * B, list(range(B)),
        cmodel=TFWModel(max_width=MAX_WIDTH[kind]), engine='walks',
        n_walks=4, device='cuda')
    card.states = type(cpu.states)(**{
        k: getattr(cpu.states, k).cuda() for k in cpu.states.field_names()})
    card._mw_pos = cpu._mw_pos.cuda()
    victims, src = [0, 2, 5, 7], 3
    jitter = jax_jitter(seed, victims, cpu.log2d_w32.numel())
    for runner in (cpu, card):
        trep.kick_lanes_fw(runner, victims, src, seed=seed, slicer=slicer,
                           jitter=jitter if slicer == 'device' else None)
    want, got = (batch_fw_to_numpy(r.states) for r in (cpu, card))
    for k, v in want.items():
        if k in _TOTALS and slicer == 'device':
            np.testing.assert_allclose(got[k], v, rtol=0, atol=TOTAL_ATOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert torch.equal(card._mw_pos.cpu(), cpu._mw_pos)

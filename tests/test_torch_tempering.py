"""The port's tempering ladder and per-lane betas vs the JAX package's.

``TemperingLadder`` is host numpy on one ``np.random.default_rng(seed)``
stream, so the ladder, the lane permutation and every swap decision must
equal the JAX package's for a seed.  Per-lane betas ``[n, B]`` run on
every engine the JAX package broadcasts them on ('batched' IM and FW,
'walks' FW, 'multiwalk' IM and FW): with equal rows they give the 1-D
run's state bitwise; the walker, which reads one beta per iteration,
raises.
"""

import numpy as np
import pytest
import torch

from tnco_tpu.parallel.tempering import TemperingLadder as JLadder
from tnco_tpu_torch.optimize.finite_width import SimpleCostModel as TFWModel
from tnco_tpu_torch.parallel import replicas as trep
from tnco_tpu_torch.parallel.tempering import TemperingLadder
from test_torch_exchange import B, tree_pairs
from torch_reference_native import reference_native  # noqa: F401


@pytest.mark.parametrize('spacing, lo', [('linear', 0.0),
                                         ('geometric', 0.5)])
@pytest.mark.parametrize('b', [2, 7, 8])
def test_ladder_matches_jax(random_seed, spacing, lo, b):
    kw = dict(beta_min=lo, beta_max=60.0, spacing=spacing, seed=random_seed)
    want, got = JLadder(b, **kw), TemperingLadder(b, **kw)
    np.testing.assert_array_equal(got.ladder, want.ladder)
    r = np.random.default_rng(random_seed)
    for _ in range(25):
        lt = r.uniform(40.0, 60.0, b)
        assert got.swap(lt) == want.swap(lt)
        np.testing.assert_array_equal(got.perm, want.perm)
        np.testing.assert_array_equal(got.lane_betas(), want.lane_betas())
    np.testing.assert_array_equal(got.betas_for(3), want.betas_for(3))
    assert (got.swaps_proposed, got.swaps_accepted, got.swap_rate) == (
        want.swaps_proposed, want.swaps_accepted, want.swap_rate)
    assert got.swaps_accepted > 0


def test_ladder_swap_math(random_seed):
    """The port of ``test_tempering.test_ladder_swap_math``."""
    lad = TemperingLadder(4, beta_min=1.0, beta_max=4.0, seed=random_seed)
    np.testing.assert_allclose(sorted(lad.lane_betas()), lad.ladder)
    # lane 0 at beta 1 (hot), lane 1 at beta 2 (cold)
    lad2 = TemperingLadder(2, beta_min=1.0, beta_max=2.0, seed=random_seed)
    assert lad2.swap(np.array([0.0, 10.0])) == 1   # hot is cheaper: swap
    lad2b = TemperingLadder(2, beta_min=1.0, beta_max=2.0, seed=random_seed)
    assert lad2b.swap(np.array([10.0, 0.0])) == 0  # cold is cheaper: keep
    lad3 = TemperingLadder(9, beta_max=30.0, seed=random_seed)
    r = np.random.default_rng(random_seed)
    for _ in range(20):
        lad3.swap(r.uniform(5, 15, size=9))
        np.testing.assert_allclose(sorted(lad3.lane_betas()), lad3.ladder)
    assert 0 < lad3.swaps_proposed
    assert 0.0 <= lad3.swap_rate <= 1.0
    with pytest.raises(ValueError, match='geometric'):
        TemperingLadder(3, spacing='geometric')
    with pytest.raises(ValueError, match='spacing'):
        TemperingLadder(3, spacing='cubic')


_ENGINES = [(False, 'batched'), (False, 'multiwalk'), (True, 'batched'),
            (True, 'walks'), (True, 'multiwalk')]


def _runner(fw, engine, trees):
    seeds = list(range(len(trees)))
    if fw:
        return trep.ReplicaRunnerFW(trees, seeds, engine=engine, n_walks=4,
                                    cmodel=TFWModel(max_width=3.0),
                                    device='cpu')
    return trep.ReplicaRunner(trees, seeds, engine=engine, n_walks=4,
                              device='cpu')


@pytest.mark.parametrize('fw, engine', _ENGINES)
def test_per_lane_betas_equal_rows_match_1d(random_seed, fw, engine):
    """``[n, B]`` betas with equal rows give the ``[n]`` run's state
    bitwise (same seeds, so the same draws)."""
    _, tt, _ = tree_pairs('lattice', random_seed % 1000)
    betas = np.linspace(0.0, 8.0, 12).astype(np.float32)
    outs = []
    for b in (betas, np.tile(betas[:, None], (1, B))):
        runner = _runner(fw, engine, tt)
        kw = {'update_slices': 3} if fw else {}
        info = runner.run(b, chunk_size=4, **kw)
        outs.append((runner.states, info['moves'], info['applied']))
    (ref, m0, a0), (got, m1, a1) = outs
    assert (m1, a1) == (m0, a0)
    for name in type(ref).field_names():
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


@pytest.mark.parametrize('fw, engine', _ENGINES)
def test_per_lane_betas_are_per_lane(random_seed, fw, engine):
    """A ladder row reaches each lane: the lanes moved to beta 0 anneal
    differently from the all-beta-30 run, and the lanes left at 30 stay
    bitwise equal to it (lanes are independent; the FW reslice's global
    condition, some replica holding slices, holds in both runs)."""
    _, tt, _ = tree_pairs('lattice', random_seed % 1000)
    hot = np.full((8, B), 30.0, dtype=np.float32)
    mixed = hot.copy()
    mixed[:, ::2] = 0.0
    states = []
    for b in (hot, mixed):
        runner = _runner(fw, engine, tt)
        runner.run(b, chunk_size=4, **({'update_slices': 3} if fw else {}))
        states.append(runner.states)
    assert torch.equal(states[0].c0[:, 1::2], states[1].c0[:, 1::2])
    assert not torch.equal(states[0].c0[:, ::2], states[1].c0[:, ::2])


@pytest.mark.parametrize('fw', [False, True])
def test_walker_refuses_per_lane_betas(random_seed, fw):
    _, tt, _ = tree_pairs('lattice', random_seed % 1000)
    runner = _runner(fw, 'walker', tt)
    with pytest.raises(ValueError, match='one beta per iteration'):
        runner.run(np.ones((4, B), dtype=np.float32))
    from tnco_tpu_torch.kernels import walker as kwalker
    with pytest.raises(ValueError, match='one beta per iteration'):
        kwalker.run_walker(runner.states, torch.ones(4, B), runner.log2d_w32,
                           runner.cfg, 4, runner._mw_pos,
                           generator=runner.generator)


def test_tempering_runner_end_to_end(random_seed):
    """Ladder-driven chunks through the FW 'walks' runner with swaps on
    the current totals between chunks (the port of
    ``test_tempering.test_tempering_runner_end_to_end``)."""
    _, tt, _ = tree_pairs('lattice', random_seed % 1000)
    runner = _runner(True, 'walks', tt)
    lad = TemperingLadder(B, beta_max=30.0, seed=random_seed)
    for _ in range(4):
        runner.run(lad.betas_for(4), chunk_size=4, update_slices=2)
        lad.swap(runner.states.log2_total.numpy())
    assert lad.swaps_proposed > 0
    idx = int(np.argmin(runner.log2_min_totals()))
    assert np.isfinite(runner.log2_min_totals()[idx])
    assert runner.min_ctree(idx).is_valid(check_shared_inds=True)

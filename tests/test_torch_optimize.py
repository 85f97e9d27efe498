"""The port's single-optimizer wrappers (``tnco_tpu_torch.optimize``):
the counterparts of ``tests/test_optimize_im.py`` and
``tests/test_optimize_fw.py``, the acceptance probabilities with their
doctests, exact Decimal costs equal to the JAX optimizers' on one state
(carried across with :mod:`tnco_tpu_torch.convert`), the ``prng_state``
round trip and its refusal across devices, and pickling.

Each optimizer owns one ``torch.Generator``: a pickled copy, and one
built from ``prng_state``, continue bitwise equal to the original.
"""

import doctest
import math
import pickle

import numpy as np
import pytest
import torch

from tnco_tpu.testing.utils import generate_random_tensors
from tnco_tpu_torch.convert import state_from_numpy, state_fw_from_numpy
from tnco_tpu_torch.ctree import ContractionTree
from tnco_tpu_torch.optimize import prob as tprob
from tnco_tpu_torch.optimize.finite_width import Optimizer as FWOptimizer
from tnco_tpu_torch.optimize.finite_width import SimpleCostModel as FWModel
from tnco_tpu_torch.optimize.infinite_memory import (Optimizer,
                                                     SimpleCostModel)
from tnco_tpu_torch.optimize.infinite_memory import optimizer as imo
from tnco_tpu_torch.optimize.prob import (BaseProbability, Greedy,
                                          MetropolisHastings)
from tnco_tpu_torch.utils.tn import get_random_contraction_path
from torch_reference_native import reference_native  # noqa: F401


def _tree(rng, random_seed, **kw):
    ts_inds, output_inds, dims = generate_random_tensors(
        rng, n_output_inds=kw.pop('n_output_inds', 2), **kw)
    (path,) = [p for p in get_random_contraction_path(
        ts_inds, output_inds, merge_paths=False, seed=random_seed) if p]
    return (ContractionTree(path, ts_inds, dims, output_inds=output_inds,
                            check_shared_inds=True),
            (path, ts_inds, dims, output_inds))


def _make_opt(rng, random_seed, **kwargs):
    ctree, _ = _tree(rng, random_seed)
    return Optimizer(ctree, SimpleCostModel(), seed=random_seed,
                     device='cpu', **kwargs)


def _make_fw(rng, random_seed, max_width, **kwargs):
    ctree, _ = _tree(rng, random_seed)
    return FWOptimizer(ctree, FWModel(max_width=max_width), seed=random_seed,
                       device='cpu', **kwargs), ctree


# --- probabilities -----------------------------------------------------------


def test_probabilities():
    base = BaseProbability()
    assert base(10.0, 1.0) == 1.0 and base(-1.0, 0.0) == 1.0
    greedy = Greedy()
    assert greedy(-1.0, 5.0) == 1.0 and greedy(0.0, 5.0) == 1.0
    assert greedy(0.5, 5.0) == 0.0
    mh = MetropolisHastings(beta=2.0)
    assert mh(-3.0, 5.0) == 1.0
    assert mh(3.0, 0.0) == 0.0
    assert mh(5.0, 10.0) == pytest.approx((1 + 0.5)**-2.0)
    assert pickle.loads(pickle.dumps(mh)) == mh
    with pytest.warns(DeprecationWarning):
        assert tprob.SimulatedAnnealing(beta=2.0) == mh
    assert [p.kind for p in (base, greedy, mh)] == ['base', 'greedy', 'mh']


def test_prob_doctests():
    """The module's doctests (the port has no doctest runner over its
    package)."""
    res = doctest.testmod(tprob)
    assert res.attempted >= 4 and res.failed == 0


# --- infinite memory (tests/test_optimize_im.py) ----------------------------


def test_update_and_audit(rng, random_seed):
    opt = _make_opt(rng, random_seed)
    prob = MetropolisHastings(beta=1.0)
    exact0 = int(opt.total_cost)
    for _ in range(20):
        opt.update(prob)
    assert opt.is_valid()
    assert opt.log2_total_cost == pytest.approx(
        math.log2(int(opt.total_cost)), abs=1e-3)
    assert opt.log2_min_total_cost == pytest.approx(
        math.log2(int(opt.min_total_cost)), abs=1e-3)
    assert int(opt.min_total_cost) <= exact0


def test_greedy_never_increases(rng, random_seed):
    opt = _make_opt(rng, random_seed)
    prev = int(opt.total_cost)
    prob = Greedy()
    for _ in range(20):
        opt.update(prob)
        cur = int(opt.total_cost)
        assert cur <= prev
        prev = cur


def test_pickle_roundtrip_and_determinism(rng, random_seed):
    opt = _make_opt(rng, random_seed)
    prob = MetropolisHastings(beta=0.5)
    for _ in range(5):
        opt.update(prob)
    clone = pickle.loads(pickle.dumps(opt))
    assert clone == opt and clone.device == opt.device
    assert clone.min_ctree == opt.min_ctree
    for _ in range(10):
        opt.update(prob)
        clone.update(prob)
    assert clone.ctree == opt.ctree
    assert clone.prng_state == opt.prng_state
    assert clone.min_total_cost == opt.min_total_cost
    m1 = opt.update_many(prob, [0.5, 1.0, 2.0])
    m2 = clone.update_many(prob, [0.5, 1.0, 2.0])
    for k in m1:
        np.testing.assert_array_equal(m1[k], m2[k])
    assert clone == opt


def test_seed_state_string_resume(rng, random_seed):
    opt = _make_opt(rng, random_seed)
    state = opt.prng_state
    assert state.startswith('torchgen:cpu:')
    opt2 = Optimizer(opt.ctree, SimpleCostModel(), seed=state,
                     min_ctree=opt.min_ctree, device='cpu')
    prob = MetropolisHastings(beta=1.0)
    for _ in range(5):
        opt.update(prob)
        opt2.update(prob)
    assert opt.ctree == opt2.ctree and opt.prng_state == opt2.prng_state


def test_sparse_cost_model(rng, random_seed):
    cm = SimpleCostModel(sparse_inds={'i'}, n_projs=3)
    assert cm.contraction_cost({'i', 'j'}, {'j', 'k'}, {'i', 'k'},
                               {'i': 2, 'j': 3, 'k': 4}) == 24
    cm2 = SimpleCostModel(sparse_inds={'i'}, n_projs=1)
    assert cm2.contraction_cost({'i', 'j'}, {'j', 'k'}, {'i', 'k'},
                                {'i': 2, 'j': 3, 'k': 4}) == 12
    with pytest.raises(ValueError):
        SimpleCostModel(sparse_inds={'i'})

    ts_inds = [('a', 'b'), ('b', 'c'), ('c', 'd')]
    ctree = ContractionTree([(0, 1), (0, 1)], ts_inds, 2,
                            check_shared_inds=True)
    cm3 = SimpleCostModel(sparse_inds={'b'}, n_projs=1)
    opt = Optimizer(ctree, cm3, seed=random_seed, device='cpu')
    assert opt.is_valid()
    prob = MetropolisHastings(beta=1.0)
    for _ in range(10):
        opt.update(prob)
    assert opt.is_valid()
    assert int(opt.min_total_cost) <= int(
        Optimizer(ctree, cm3, seed=1, device='cpu').total_cost)


def test_disable_shared_inds(rng, random_seed):
    opt = _make_opt(rng, random_seed, disable_shared_inds=True)
    prob = BaseProbability()  # always accept: maximum churn
    for _ in range(15):
        opt.update(prob)
    ok, msg = opt.is_valid(return_message=True)
    assert ok, msg
    assert opt.log2_total_cost == pytest.approx(
        math.log2(int(opt.total_cost)), abs=1e-3)
    clone = pickle.loads(pickle.dumps(opt))
    assert clone.disable_shared_inds


# --- finite width (tests/test_optimize_fw.py) -------------------------------


def test_cost_model_widths():
    cm = FWModel(max_width=8)
    dims = {'i': 2, 'j': 4, 'k': 8}
    assert cm.width({'i', 'j'}, dims) == pytest.approx(3.0)
    assert cm.delta_width({'i', 'j'}, dims, 'k') == pytest.approx(3.0)
    assert cm.delta_width({'i', 'j'}, dims, 'j') == pytest.approx(-2.0)
    assert cm.contraction_cost({'i'}, {'i', 'j'}, {'j'}, dims,
                               slices={'k'}) == 2 * 4 * 8
    cms = FWModel(max_width=8, sparse_inds={'j', 'k'}, n_projs=4)
    assert cms.width({'i', 'j', 'k'}, dims) == pytest.approx(1 + 2.0)
    assert cms.contraction_cost({'i', 'j'}, {'j', 'k'}, {'i', 'k'},
                                dims) == 2 * min(32, 4)


@pytest.mark.parametrize('max_width', [2.0, 4.0])
@pytest.mark.parametrize('rep', range(3))
def test_update_respects_width(rep, max_width, rng, random_seed):
    opt, _ = _make_fw(rng, random_seed, max_width)
    assert opt.is_valid()
    prob = MetropolisHastings(beta=1.0)
    for i in range(15):
        opt.update(prob, update_slices=(i % 5 == 0))
    ok, msg = opt.is_valid(return_message=True)
    assert ok, msg
    assert opt.log2_total_cost == pytest.approx(
        math.log2(int(opt.total_cost)), abs=1e-3)
    assert opt.log2_min_total_cost == pytest.approx(
        math.log2(int(opt.min_total_cost)), abs=1e-3)
    dims = opt.ctree.dims
    for xs in opt.ctree.inds:
        assert opt.cmodel.width(frozenset(xs) - opt.slices,
                                dims) <= max_width + 1e-3


def test_wide_limit_has_no_slices(rng, random_seed):
    opt, _ = _make_fw(rng, random_seed, max_width=1e6)
    assert opt.slices == frozenset()
    prob = MetropolisHastings(beta=1.0)
    for _ in range(10):
        opt.update(prob)
    assert opt.slices == frozenset()
    assert opt.is_valid()


def test_max_number_new_slices(rng, random_seed):
    opt, _ = _make_fw(rng, random_seed, max_width=2.0,
                      max_number_new_slices=2)
    prob = MetropolisHastings(beta=0.5)
    for i in range(15):
        opt.update(prob, update_slices=(i % 5 == 0))
    ok, msg = opt.is_valid(return_message=True)
    assert ok, msg


def test_greedy_monotone_fw(rng, random_seed):
    opt, _ = _make_fw(rng, random_seed, max_width=3.0)
    prob = Greedy()
    prev = int(opt.total_cost)
    for i in range(10):
        opt.update(prob, update_slices=(i % 3 == 0))
        cur = int(opt.total_cost)
        assert cur <= prev     # a reslice applies only when strictly better
        prev = cur


def test_pickle_and_determinism_fw(rng, random_seed):
    opt, _ = _make_fw(rng, random_seed, max_width=3.0)
    prob = MetropolisHastings(beta=0.7)
    for _ in range(5):
        opt.update(prob)
    clone = pickle.loads(pickle.dumps(opt))
    assert clone == opt
    for i in range(8):
        opt.update(prob, update_slices=(i % 2 == 0))
        clone.update(prob, update_slices=(i % 2 == 0))
    assert clone.ctree == opt.ctree
    assert clone.slices == opt.slices
    assert clone.min_slices == opt.min_slices
    assert clone.min_total_cost == opt.min_total_cost
    assert clone.prng_state == opt.prng_state
    # From prng_state and the labels, as a user resumes by hand.
    again = FWOptimizer(opt.ctree, opt.cmodel, seed=opt.prng_state,
                        slices=opt.slices, min_ctree=opt.min_ctree,
                        min_slices=opt.min_slices, device='cpu')
    assert again == opt
    for _ in range(4):
        opt.update(prob)
        again.update(prob)
    assert again == opt


def test_skip_slices(rng, random_seed):
    ctree, _ = _tree(rng, random_seed, n_output_inds=1, min_dim=2,
                     max_dim=2)
    skip = next(iter(ctree.all_inds()))
    opt = FWOptimizer(ctree, FWModel(max_width=2.0), seed=random_seed,
                      skip_slices=[skip], device='cpu')
    prob = MetropolisHastings(beta=1.0)
    for _ in range(10):
        opt.update(prob, update_slices=True)
        assert skip not in opt.slices
        assert skip not in opt.min_slices
    assert opt.is_valid()
    with pytest.raises(ValueError, match='unknown'):
        FWOptimizer(ctree, FWModel(max_width=2.0), skip_slices=['nope'],
                    device='cpu')
    with pytest.raises(ValueError, match='fitting'):
        FWOptimizer(ctree, FWModel(max_width=0.5),
                    skip_slices=list(ctree.all_inds()), device='cpu')


# --- against the JAX optimizers, prng_state, devices ------------------------


def _jax_fields(state):
    return {k: np.asarray(getattr(state, k)) for k in state.__slots__}


@pytest.mark.parametrize('fw', [False, True])
def test_decimal_costs_match_jax(rng, random_seed, fw):
    """From the state of a JAX optimizer that ran 6 updates, carried
    across: the same trees, slices, exact Decimal costs, log2 costs
    within 1e-5, and a clean ``is_valid``."""
    from tnco_tpu.ctree import ContractionTree as JTree
    from tnco_tpu.optimize import finite_width as jfw
    from tnco_tpu.optimize import infinite_memory as jim
    from tnco_tpu.optimize.prob import MetropolisHastings as JMH

    ctree, (path, ts, dims, out) = _tree(rng, random_seed)
    jtree = JTree(path, ts, dims, output_inds=out, check_shared_inds=True)
    if fw:
        jopt = jfw.Optimizer(jtree, jfw.SimpleCostModel(max_width=3.0),
                             seed=random_seed)
        topt = FWOptimizer(ctree, FWModel(max_width=3.0), seed=0,
                           device='cpu')
    else:
        jopt = jim.Optimizer(jtree, jim.SimpleCostModel(), seed=random_seed)
        topt = Optimizer(ctree, SimpleCostModel(), seed=0, device='cpu')
    for i in range(6):
        if fw:
            jopt.update(JMH(beta=1.0), update_slices=i % 2 == 0)
        else:
            jopt.update(JMH(beta=1.0))
    conv = state_fw_from_numpy if fw else state_from_numpy
    topt._state = conv(_jax_fields(jopt._state), 'cpu')
    ok, msg = topt.is_valid(return_message=True)
    assert ok, msg
    np.testing.assert_array_equal(topt.ctree.nodes_array,
                                  jopt.ctree.nodes_array)
    assert topt.total_cost == jopt.total_cost
    assert topt.min_total_cost == jopt.min_total_cost
    assert abs(topt.log2_min_total_cost - jopt.log2_min_total_cost) <= 1e-5
    if fw:
        assert topt.slices == jopt.slices
        assert topt.min_slices == jopt.min_slices


def test_prng_state_refused_across_devices(rng, random_seed):
    """A state of another device type raises, naming both devices; an
    unknown string raises too; None draws a fresh seed."""
    opt = _make_opt(rng, random_seed)
    card_state = 'torchgen:cuda:' + bytes(16).hex()
    with pytest.raises(ValueError, match="'cuda'.*'cpu'"):
        Optimizer(opt.ctree, SimpleCostModel(), seed=card_state,
                  device='cpu')
    with pytest.raises(ValueError, match="'cpu'.*'cuda'"):
        imo.state_to_generator(opt.prng_state, 'cuda')
    with pytest.raises(ValueError, match='Not a valid'):
        Optimizer(opt.ctree, SimpleCostModel(), seed='jaxkey:00',
                  device='cpu')
    with pytest.raises(ValueError, match="'cuda'.*'cpu'"):
        FWOptimizer(opt.ctree, FWModel(max_width=4.0), seed=card_state,
                    device='cpu')
    a = Optimizer(opt.ctree, SimpleCostModel(), device='cpu')
    b = Optimizer(opt.ctree, SimpleCostModel(), device='cpu')
    assert a.prng_state != b.prng_state
    gen = imo.state_to_generator(opt.prng_state, 'cpu')
    assert torch.equal(gen.get_state(), opt._generator.get_state())


def test_optimizer_device_rule(monkeypatch, rng, random_seed):
    """``device=None`` means the card: without CUDA it raises and asks for
    ``device='cpu'``."""
    ctree, _ = _tree(rng, random_seed)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Optimizer(ctree, SimpleCostModel())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FWOptimizer(ctree, FWModel(max_width=3.0))


@pytest.mark.cuda
def test_optimizers_on_card(rng, random_seed):
    """On the card: updates, ``is_valid``, and a pickled copy that
    continues bitwise."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    ctree, _ = _tree(rng, random_seed)
    for opt in (Optimizer(ctree, SimpleCostModel(), seed=1),
                FWOptimizer(ctree, FWModel(max_width=3.0), seed=1)):
        assert opt.prng_state.startswith('torchgen:cuda:')
        for _ in range(4):
            opt.update(MetropolisHastings(beta=1.0))
        clone = pickle.loads(pickle.dumps(opt))
        for _ in range(4):
            opt.update(MetropolisHastings(beta=1.0))
            clone.update(MetropolisHastings(beta=1.0))
        assert clone == opt and opt.is_valid()

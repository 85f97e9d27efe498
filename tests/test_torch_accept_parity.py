"""The port's acceptance-parity study (``testing.accept_parity``): the
flip-rate bounds of ``tests/test_accept_parity.py`` on states the port's
lockstep engine sampled, and, on the states the JAX package sampled,
exactly the JAX package's numbers (same mirrors, same oracle, same
draws)."""

from random import Random

import pytest

from tnco_tpu.ctree import ContractionTree as JTree
from tnco_tpu.testing import accept_parity as jap
from tnco_tpu.testing.utils import generate_random_tensors
from tnco_tpu_torch.ctree import ContractionTree
from tnco_tpu_torch.testing.accept_parity import measure_flip_rate
from tnco_tpu_torch.utils.tn import get_random_contraction_path
from torch_reference_native import reference_native  # noqa: F401


def _network():
    ts_inds, output_inds, dims = generate_random_tensors(
        Random(0), n_tensors=16, n_output_inds=2, min_dim=2, max_dim=4)
    order = tuple(dict.fromkeys(x for xs in ts_inds for x in xs))
    (path,) = [p for p in get_random_contraction_path(
        ts_inds, output_inds, merge_paths=False, seed=0) if p]
    kw = dict(output_inds=output_inds, check_shared_inds=True,
              inds_order=order)
    return (ContractionTree(path, ts_inds, dims, **kw),
            JTree(path, ts_inds, dims, **kw))


@pytest.fixture(scope='module')
def parity_result():
    return measure_flip_rate(_network()[0], n_states=4, n_u=2, seed=0,
                             device='cpu')


def test_flip_rate_bounds(parity_result):
    """The JAX test's bounds (about 5x the measured 4-seed maxima)."""
    res = parity_result
    assert res['total_float32']['expected_rate'] < 2e-5
    assert res['local_float32']['expected_rate'] < 2e-6
    assert res['total_float64']['expected_rate'] < 5e-8
    assert res['local_float64']['expected_rate'] < 5e-8
    assert (res['local_float32']['expected_rate'] <=
            res['total_float32']['expected_rate'])


def test_sampled_flips_consistent(parity_result):
    res = parity_result
    for key in ('total_float32', 'local_float32',
                'total_float64', 'local_float64'):
        assert res[key]['flips'] <= 1, (key, res[key])
        assert res[key]['proposals'] > 300


def test_matches_jax_on_jax_states():
    """On the states the JAX package sampled (2 replicas, a short warm-up),
    every number of the port's study equals the JAX study's."""
    tree, jtree = _network()
    betas = [0.0, 20.0, 40.0, 60.0]
    states = jap.sample_states(jtree, [0, 1], betas)
    want = jap.measure_flip_rate(jtree, n_states=2, n_u=2, seed=3,
                                 betas_warmup=betas)
    got = measure_flip_rate(tree, n_u=2, seed=3, states=states)
    assert got == want

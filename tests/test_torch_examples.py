"""The three flows of ``examples/`` through the port on ``device='cpu'``
(``tnco_tpu_torch.testing.examples``, which ``chip_smoke.py`` runs on the
card), each audited, and their deterministic outputs held against the
JAX package: the chain's tree, ``max_width()``, exact cost, ``path()``
and ``get_contraction``; the optimized trees' costs, paths and
contractions as the reference computes them from the port's arrays; the
loaded lattice.  The annealing's draws differ between the packages, so
the optimized trees are the port's own.

Tolerance: trees, paths, costs and widths exactly; the sampled
amplitudes within ``AMPLITUDE_ATOL`` (1e-10) of a statevector and the
frequencies within ``TV_MAX`` (0.35) in total variation."""

from random import Random

import numpy as np

from tnco_tpu.app import load_tn as jload_tn
from tnco_tpu.ctree import (ContractionTree as JContractionTree,
                            get_contraction as jget_contraction)
from tnco_tpu.optimize.finite_width import SimpleCostModel as JFWModel
from tnco_tpu.testing.utils import generate_random_tensors as jgen
from tnco_tpu_torch.ctree import get_contraction
from tnco_tpu_torch.testing import examples as ex
from torch_reference_native import reference_native  # noqa: F401


def _same_tree(tree, jtree):
    np.testing.assert_array_equal(tree.nodes_array, jtree.nodes_array)
    np.testing.assert_array_equal(tree.inds_array, jtree.inds_array)
    assert tree.max_width() == jtree.max_width()
    assert tree.total_cost_exact() == jtree.total_cost_exact()
    assert tree.path() == jtree.path()
    assert get_contraction(tree) == jget_contraction(jtree)


def test_base_optimization_flow():
    out = ex.base_optimization('cpu')
    ex.audit_base_optimization(out)
    path, ts_inds, dims = ex.CHAIN
    jtree = JContractionTree(path, ts_inds, dims, check_shared_inds=True)
    _same_tree(out['ctree'], jtree)
    assert out['max_width'] == jtree.max_width() == 5.0
    assert out['cost'] == jtree.total_cost_exact() == 160
    for opt in (out['opt'], out['fw']):
        tree = opt.min_ctree
        _same_tree(tree, jtree.replace_arrays(tree.nodes_array.copy(),
                                              tree.inds_array.copy()))
        assert JContractionTree(tree.path(), ts_inds, dims,
                                check_shared_inds=True).is_valid()
    assert int(out['opt'].min_total_cost) == \
        out['opt'].min_ctree.total_cost_exact()
    jcm, tree = JFWModel(max_width=4.0), out['fw'].min_ctree
    slices = out['fw'].min_slices
    want = sum(jcm.contraction_cost(tree.inds[n.children[0]],
                                    tree.inds[n.children[1]], tree.inds[pos],
                                    tree.dims, slices)
               for pos, n in enumerate(tree.nodes) if not n.is_leaf())
    assert int(out['fw'].min_total_cost) == want
    assert out['opt'].prng_state.startswith('torchgen:cpu:')


def test_optimization_flow():
    tn, runs = ex.optimization('cpu')
    ex.audit_optimization(tn, runs)
    jtn = jload_tn(ex.lattice_rows(), fuse=False)
    assert tn.ts_inds == jtn.ts_inds and tn.dims == jtn.dims
    assert tn.output_inds == jtn.output_inds
    jcm = JFWModel(max_width=3.0)
    for name, (_, results) in runs.items():
        best = results[0]
        jtree = JContractionTree(best.path, jtn.ts_inds, jtn.dims,
                                 output_inds=jtn.output_inds)
        slices = frozenset(getattr(best, 'slices', ()))
        want = sum(jcm.contraction_cost(jtree.inds[n.children[0]],
                                        jtree.inds[n.children[1]],
                                        jtree.inds[pos], jtree.dims, slices)
                   for pos, n in enumerate(jtree.nodes) if not n.is_leaf())
        assert int(best.cost) == want, name
        if name == 'max_width':
            assert jcm.get_max_width([xs - slices for xs in jtree.inds],
                                     jtree.dims) <= 3.0
        else:
            assert not slices and int(best.cost) == \
                jtree.total_cost_exact()


def test_sampling_flow():
    out = ex.sampling('cpu')
    err = ex.audit_sampling(out)
    assert err <= ex.AMPLITUDE_ATOL
    assert len(out['hits']) > 1 and len(out['hits_capped']) > 1


def test_random_networks_flow():
    """The random networks of the JAX package's tests (the port's
    generator, equal to the reference's for each seed) through the app's
    ``Optimizer`` IM and FW, every result audited; each best path valid
    in the reference's ``ContractionTree`` and, on a connected network
    without slices, of the reference's exact cost."""
    runs = ex.random_networks('cpu')
    assert ex.audit_random_networks(runs) == 4 * len(runs)
    for seed, kw in enumerate(ex.RANDOM_SHAPES):
        assert runs[2 * seed][0] == jgen(Random(seed), **kw)
    for _, fw, tn, results in runs:
        best = results[0]
        jtree = JContractionTree(best.path, tn.ts_inds, tn.dims,
                                 output_inds=tn.output_inds)
        assert jtree.is_valid()
        if not fw and len(best.disconnected_costs) == 1:
            assert int(best.cost) == jtree.total_cost_exact()

"""Port batch state, its numpy carry-over, and the initial paths.

``init_batch_fw`` must equal the JAX package's on the same trees and
seeds (integer fields and costs bitwise: both build them with the same
numpy arithmetic); the greedy initial paths must be the same paths
opt_einsum 3.4.0 gives.
"""

import numpy as np
import pytest
import torch

from benchmarks.networks import lattice_2d, sycamore_like_tn
from tnco_tpu.ctree import ContractionTree
from tnco_tpu.kernels import sa_finite_batched as jsfb
from tnco_tpu.ops import bitops as jbit
from tnco_tpu.testing.utils import generate_random_tensors
import tnco_tpu.utils.tn as jtn
from tnco_tpu_torch.convert import batch_fw_from_numpy, batch_fw_to_numpy
from tnco_tpu_torch.ctree import ContractionTree as TContractionTree
from tnco_tpu_torch.kernels import sa_finite_batched as tsfb
from tnco_tpu_torch.testing import networks as tnets
import tnco_tpu_torch.utils.tn as ttn
from torch_reference_native import reference_native  # noqa: F401


def _trees(ts, out, dims, b, seed, cls=ContractionTree):
    return [cls(jtn.get_random_contraction_path(ts, out, seed=seed + i), ts,
                dims, output_inds=out) for i in range(b)]


@pytest.mark.parametrize('net,max_width', [('lattice', 4.0),
                                           ('random', 6.0)])
def test_init_batch_fw_matches_jax(random_seed, net, max_width):
    if net == 'lattice':
        ts, out, dims = lattice_2d(4, 5)
    else:
        ts, out, dims = generate_random_tensors(
            random_seed, n_tensors=14, min_dim=2, max_dim=2,
            n_output_inds=1, use_mixed_labels=False)
    b = 3
    ctrees = _trees(ts, out, dims, b, random_seed)
    w = ctrees[0].inds_array.shape[1]
    log2d = np.asarray(jbit.pad_log2_dims(ctrees[0].log2_dims_array, w))
    seeds = [random_seed + i for i in range(b)]
    ref = jsfb.init_batch_fw(ctrees, seeds, max_width, log2d)
    got = tsfb.init_batch_fw(ctrees, seeds, max_width, log2d, device='cpu')
    g = batch_fw_to_numpy(got)
    for name in ('c0', 'c1', 'par', 'inds', 'hyper', 'lcc', 'width',
                 'slices', 'min_c0', 'min_c1', 'min_par', 'min_inds',
                 'min_slices', 'log2_total', 'min_log2_total'):
        np.testing.assert_array_equal(g[name], np.asarray(getattr(ref, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(g['keys'][:, 1], np.asarray(seeds))


def test_convert_round_trip(random_seed):
    ts, out, dims = lattice_2d(3, 4)
    ctrees = _trees(ts, out, dims, 2, random_seed)
    w = ctrees[0].inds_array.shape[1]
    log2d = np.asarray(jbit.pad_log2_dims(ctrees[0].log2_dims_array, w))
    ref = jsfb.init_batch_fw(ctrees, [1, 2], 3.0, log2d)
    fields = {k: np.asarray(getattr(ref, k)) for k in ref.__slots__}
    batch = batch_fw_from_numpy(fields, 'cpu')
    assert batch.inds.dtype == torch.int32
    assert batch.lcc.dtype == torch.float32
    back = batch_fw_to_numpy(batch)
    assert set(back) == set(fields)
    for k, v in fields.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize('case', range(6))
def test_random_paths_match_jax(random_seed, case):
    ts, out, dims = generate_random_tensors(
        random_seed + case, max_n_tensors=25, n_hyper_edges=case % 3,
        n_output_inds=case % 2, n_hyper_output_inds=case % 2,
        n_ccs=1 + case % 2)
    for seed in range(3):
        for merge in (True, False):
            want = jtn.get_random_contraction_path(ts, out, seed=seed,
                                                   merge_paths=merge)
            got = ttn.get_random_contraction_path(ts, out, seed=seed,
                                                  merge_paths=merge)
            assert got == want


@pytest.mark.parametrize('net', ['lattice', 'sycamore'])
def test_network_paths_match_jax(net):
    if net == 'lattice':
        ts, out, _ = tnets.lattice_2d(4, 4)
        assert (ts, out) == lattice_2d(4, 4)[:2]
    else:
        ts, out, _ = tnets.sycamore_like_tn(3)
        assert (ts, out) == sycamore_like_tn(3)[:2]
    for seed in (0, 7):
        assert (ttn.get_random_contraction_path(ts, out, seed=seed) ==
                jtn.get_random_contraction_path(ts, out, seed=seed))


def test_ctree_copy_matches_jax(random_seed):
    ts, out, dims = generate_random_tensors(random_seed, n_hyper_edges=2,
                                            n_output_inds=2)
    path = jtn.get_random_contraction_path(ts, out, seed=random_seed)
    a = ContractionTree(path, ts, dims, output_inds=out)
    b = TContractionTree(path, ts, dims, output_inds=out)
    np.testing.assert_array_equal(a.nodes_array, b.nodes_array)
    np.testing.assert_array_equal(a.inds_array, b.inds_array)
    assert a.total_cost_exact() == b.total_cost_exact()
    assert a.path() == b.path()
    assert b.is_valid(check_shared_inds=False)

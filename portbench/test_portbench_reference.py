"""The plain reference against the program's host tree on the CPU, and
its refusal of broken trees."""

import itertools
import math

import numpy as np
import pytest
import torch

from portbench import networks, paths, reference
from tnco_tpu_torch.ctree import ContractionTree


@pytest.fixture(scope='module')
def net():
    ts_inds, output_inds, dims = networks.build(
        {'generator': 'sycamore53', 'm_cycles': 20})
    order = tuple(dict.fromkeys(itertools.chain.from_iterable(ts_inds)))
    ref = reference.Reference(ts_inds, output_inds, dims, order)
    path = paths.random_path(ts_inds, output_inds, dims, 5)
    tree = ContractionTree(path, ts_inds, dims, output_inds=output_inds,
                           check_shared_inds=True, inds_order=order)
    return ref, path, tree


def _cols(tree):
    nodes = tree.nodes_array
    return nodes[:, 0].copy(), nodes[:, 1].copy(), nodes[:, 2].copy()


def test_costs_are_the_programs_exact_costs(net):
    ref, path, tree = net
    want = tree.total_cost_exact()
    assert ref.path_report(path).total == want
    rep = ref.tree_report(*_cols(tree))
    assert rep.valid and rep.total == want
    assert sorted(rep.log2_costs) == sorted(
        x for x in tree.contraction_log2_costs() if math.isfinite(x))


def test_shapes_of_path_and_tree_agree(net):
    ref, path, tree = net
    assert reference.path_shape(path, ref.n_leaves) == \
        reference.tree_shape(*_cols(tree), ref.n_leaves)
    c0, c1, par = _cols(tree)
    root = int(np.flatnonzero(par == -1)[0])
    c0[root], c1[root] = c1[root], c0[root]   # the same tree
    assert reference.tree_shape(c0, c1, par, ref.n_leaves) == \
        reference.path_shape(path, ref.n_leaves)


def test_slices_charge_every_contraction_and_cap_widths(net):
    ref, _, tree = net
    sliced = (1 << 3) | (1 << 700)
    rep = ref.tree_report(*_cols(tree), slices=sliced, max_width=30)
    plain = ref.tree_report(*_cols(tree))
    assert rep.valid
    bits = tree.inds_array
    dense = np.array([int(sum(bin(int(x) & 0xFFFFFFFF).count('1')
                              for x in row)) for row in bits])
    # Each contraction's cost counts the sliced indices it lacks too.
    assert rep.total >= plain.total
    assert rep.log2_total <= plain.log2_total + 2 + 1e-9
    # A node's width after slicing: its own bits less the sliced ones.
    lanes = np.zeros(bits.shape[1], dtype=np.uint32)
    lanes[0] = 1 << 3
    lanes[700 // 32] |= np.uint32(1 << (700 % 32))
    cut = np.array([int(sum(bin(int(x) & int(m)).count('1')
                            for x, m in zip(row, lanes))) for row in bits])
    assert rep.over_cap == int(((dense - cut) > 30).sum())
    assert reference.lanes_to_mask(lanes) == sliced


@pytest.mark.parametrize('fault', ['leaf_child', 'twin_children',
                                   'wrong_parent', 'two_roots', 'cycle',
                                   'short', 'slice_out_of_range'])
def test_broken_trees_are_refused(net, fault):
    ref, _, tree = net
    c0, c1, par = _cols(tree)
    n_leaves = ref.n_leaves
    slices = 0
    root = int(np.flatnonzero(par == -1)[0])
    node = int(c0[root]) if c0[root] >= n_leaves else int(c1[root])
    if fault == 'leaf_child':
        c0[0] = node
    elif fault == 'twin_children':
        c1[node] = c0[node]
    elif fault == 'wrong_parent':
        par[c0[node]] = node + 1 if node + 1 != root else node - 1
    elif fault == 'two_roots':
        par[node] = -1
    elif fault == 'cycle':
        # The root's child points back at the root as its child.
        c0[node] = root
        par[root] = node
    elif fault == 'short':
        c0, c1, par = c0[:-1], c1[:-1], par[:-1]
    else:
        slices = 1 << ref.n_bits
    rep = ref.tree_report(c0, c1, par, slices=slices)
    assert not rep.valid, fault


def test_bfloat16_control_departs_and_float32_does_not(net):
    ref, _, _ = net
    ts_inds, output_inds, dims = networks.build(
        {'generator': 'sycamore53', 'm_cycles': 20})
    gaps = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for seed in range(1, 9):
        rep = ref.path_report(paths.random_path(ts_inds, output_inds, dims,
                                                seed))
        for dtype in gaps:
            gaps[dtype] = max(gaps[dtype], abs(reference.log2_total_lowp(
                rep.log2_costs, dtype) - rep.log2_total))
    assert gaps[torch.float32] < 1e-4
    assert gaps[torch.bfloat16] > 1e-2

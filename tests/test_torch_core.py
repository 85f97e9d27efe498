"""The port's host core against the JAX package's, on the same seeded
inputs: the counterpart of ``tests/test_core.py`` (bitset, ordered
frozenset, ``Node``, ``ContractionTree``, ``get_contraction``), each test
also run through the reference, and the names the port's first slices
left out: ``Node.is_root``, ``ContractionTree.max_width``,
``contraction_log2_costs``, ``swap_with_nn``, ``traverse_tree``,
``Bitset.from_mask``/``test``/``visit``, the FW cost model's
``get_max_width`` and ``ops.bitops``' ``any_bits``/``popcount``.

Tolerance: none.  Values are compared exactly (floats bitwise, -inf on
leaves, ints and label sets by equality), exceptions by type and
message."""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnco_tpu.bitset import Bitset as JBitset
from tnco_tpu.ctree import (ContractionTree as JContractionTree, Node as
                            JNode, get_contraction as jget_contraction,
                            traverse_tree as jtraverse_tree)
from tnco_tpu.ops import bitops as jbitops
from tnco_tpu.optimize.finite_width import SimpleCostModel as JFWModel
from tnco_tpu.ordered_frozenset import OrderedFrozenSet as JOrderedFrozenSet
from tnco_tpu.testing import utils as jtu
from tnco_tpu.utils.tn import get_random_contraction_path
from tnco_tpu_torch.bitset import Bitset, pack_lanes, unpack_lanes
from tnco_tpu_torch.ctree import (ContractionTree, Node, get_contraction,
                                  traverse_tree)
from tnco_tpu_torch.ops import bitops
from tnco_tpu_torch.optimize.finite_width import SimpleCostModel
from tnco_tpu_torch.ordered_frozenset import OrderedFrozenSet
from tnco_tpu_torch.testing import utils as tu
from torch_reference_native import reference_native  # noqa: F401


def _raises(fn, *args, **kwargs):
    """``(type name, message)`` of what ``fn`` raises, or None."""
    try:
        fn(*args, **kwargs)
    except Exception as exc:  # noqa: BLE001 -- compared across packages
        return type(exc).__name__, str(exc)
    return None


def _same_raise(port_fn, ref_fn, *args, **kwargs):
    got = _raises(port_fn, *args, **kwargs)
    assert got is not None
    assert got == _raises(ref_fn, *args, **kwargs)


def _random_pair(rng, random_seed, hyper=False, **kwargs):
    """One random network from both generators (equal for one seed) and
    its tree in both packages."""
    kw = dict(n_hyper_edges=2 if hyper else 0, n_output_inds=2,
              n_hyper_output_inds=1 if hyper else 0, **kwargs)
    state = rng.getstate()
    net = tu.generate_random_tensors(rng, **kw)
    rng.setstate(state)
    assert jtu.generate_random_tensors(rng, **kw) == net
    ts_inds, output_inds, dims = net
    paths = get_random_contraction_path(ts_inds, output_inds,
                                        merge_paths=False, seed=random_seed)
    (path,) = [p for p in paths if p]
    kw = dict(output_inds=output_inds, check_shared_inds=True)
    return (net, ContractionTree(path, ts_inds, dims, **kw),
            JContractionTree(path, ts_inds, dims, **kw))


@pytest.mark.parametrize('rep', range(20))
def test_bitset_vs_frozenset(rep, rng):
    n = rng.randint(1, 100)
    pa = frozenset(rng.sample(range(n), k=rng.randint(0, n)))
    pb = frozenset(rng.sample(range(n), k=rng.randint(0, n)))
    a, b = Bitset(pa, n=n), Bitset(pb, n=n)
    ja, jb = JBitset(pa, n=n), JBitset(pb, n=n)

    assert frozenset(a.positions()) == pa
    assert a.count() == len(pa)
    assert frozenset((a & b).positions()) == pa & pb
    assert frozenset((a | b).positions()) == pa | pb
    assert frozenset((a ^ b).positions()) == pa ^ pb
    assert frozenset((a - b).positions()) == pa - pb
    assert frozenset((~a).positions()) == frozenset(range(n)) - pa
    assert a.intersects(b) == bool(pa & pb)
    assert a.issubset(b) == pa.issubset(pb)
    assert a.issuperset(b) == pa.issuperset(pb)
    assert (a <= b) == (pa <= pb)
    assert (a < b) == (pa < pb)
    for op in ('__and__', '__or__', '__xor__', '__sub__'):
        assert str(getattr(a, op)(b)) == str(getattr(ja, op)(jb))
    assert str(~a) == str(~ja) and a.positions() == ja.positions()

    # String codec round trip (char j = bit j)
    assert Bitset(str(a)) == a and str(a) == str(ja)
    assert pickle.loads(pickle.dumps(a)) == a

    # Lane pack/unpack round trip
    lanes = a.lanes()
    np.testing.assert_array_equal(lanes, ja.lanes())
    assert unpack_lanes(lanes) == a.mask
    assert Bitset.from_lanes(lanes, n) == a
    assert np.array_equal(pack_lanes(a.mask, n), lanes)

    # from_mask, test, visit
    assert Bitset.from_mask(a.mask, n) == a
    assert str(Bitset.from_mask(a.mask, n)) == str(JBitset.from_mask(a.mask,
                                                                     n))
    assert [a.test(i) for i in range(n)] == [ja.test(i) for i in range(n)]
    assert [a.test(i) for i in range(n)] == [i in pa for i in range(n)]
    seen, jseen = [], []
    a.visit(seen.append)
    ja.visit(jseen.append)
    assert seen == jseen == sorted(pa)
    for pos in (-1, n):
        _same_raise(a.test, ja.test, pos)
    _same_raise(Bitset.from_mask, JBitset.from_mask, 1 << n, n)
    _same_raise(Bitset.from_mask, JBitset.from_mask, -1, n)


def test_bitset_validation():
    for cls in (Bitset, JBitset):
        with pytest.raises(ValueError):
            cls([5], n=3)
        with pytest.raises(ValueError):
            cls('012')
        b = cls('0101')
        assert b.positions() == (1, 3)
        assert str(b.set(0)) == '1101'
        assert str(b.reset(1)) == '0001'
    for args, kw in ((([5],), dict(n=3)), (('012',), {}), ((3,), {}),
                     (((1,),), {}), (('01',), dict(n=3)), ((), {})):
        _same_raise(Bitset, JBitset, *args, **kw)


@pytest.mark.parametrize('rep', range(10))
def test_ordered_frozenset(rep, rng):
    xs = [rng.randrange(50) for _ in range(rng.randint(0, 30))]
    ys = [rng.randrange(50) for _ in range(rng.randint(0, 30))]
    a, b = OrderedFrozenSet(xs), OrderedFrozenSet(ys)
    ja, jb = JOrderedFrozenSet(xs), JOrderedFrozenSet(ys)
    fa, fb = frozenset(xs), frozenset(ys)
    assert frozenset(a) == fa and len(a) == len(fa)
    assert frozenset(a & b) == fa & fb
    assert frozenset(a | b) == fa | fb
    assert frozenset(a - b) == fa - fb
    assert frozenset(a ^ b) == fa ^ fb
    assert a.issubset(b) == fa.issubset(fb)
    assert a == fa
    assert hash(a) == hash(OrderedFrozenSet(reversed(xs)))
    # Insertion order is preserved, as in the reference's
    assert list(a) == list(dict.fromkeys(xs)) == list(ja)
    for op in ('__and__', '__or__', '__sub__', '__xor__'):
        assert list(getattr(a, op)(b)) == list(getattr(ja, op)(jb))
    assert pickle.loads(pickle.dumps(a)) == a


def test_node():
    n = Node((0, 1), 2)
    assert not n.is_leaf() and not n.is_root()
    assert Node().is_leaf() and Node().is_root()
    with pytest.raises(ValueError):
        Node((0, 0), 1)
    with pytest.raises(ValueError):
        Node((0, None), 1)
    with pytest.raises(ValueError):
        Node((0, 1), 0)
    assert pickle.loads(pickle.dumps(n)) == n
    for children, parent in (((0, 1), 2), ((None, None), None),
                             ((None, None), 3), ((4, 5), None),
                             ((-1, -1), -1)):
        got, want = Node(children, parent), JNode(children, parent)
        assert (got.is_leaf(), got.is_root(), got.children, got.parent) == \
            (want.is_leaf(), want.is_root(), want.children, want.parent)
    for children, parent in (((0, 0), 1), ((0, None), 1), ((0, 1), 0)):
        _same_raise(Node, JNode, children, parent)


def test_ctree_chain():
    # README 4-tensor chain: i-j-k-l, all dims 2
    path = [(0, 1), (0, 1), (0, 1)]
    ts_inds = [['i', 'j'], ['j', 'k'], ['k', 'l'], ['l', 'm']]
    dims = {'i': 2, 'j': 2, 'k': 2, 'l': 2, 'm': 2}
    ctree = ContractionTree(path, ts_inds, dims, check_shared_inds=True)
    jtree = JContractionTree(path, ts_inds, dims, check_shared_inds=True)
    assert len(ctree) == 7
    assert ctree.n_leaves == 4
    assert ctree.max_width() == jtree.max_width() == 2.0
    assert ctree.output_inds() == frozenset({'i', 'm'})
    # Exact cost: ((ij,jk->ik): 8) + ((ik,kl->il): 8) + ((il,lm->im): 8)
    assert ctree.total_cost_exact() == jtree.total_cost_exact() == 24
    assert tu.is_valid_contraction_tree(ctree, ts_inds, None, dims)
    assert tu.exact_contraction_costs(ctree) == \
        jtu.exact_contraction_costs(jtree) == [0, 0, 0, 0, 8, 8, 8]


@pytest.mark.parametrize('hyper', [False, True])
@pytest.mark.parametrize('rep', range(8))
def test_ctree_random_roundtrip(rep, hyper, rng, random_seed):
    (ts_inds, output_inds, dims), ctree, jtree = _random_pair(
        rng, random_seed, hyper)
    assert tu.is_valid_contraction_tree(ctree, ts_inds, output_inds, dims)
    assert jtu.is_valid_contraction_tree(jtree, ts_inds, output_inds, dims)
    np.testing.assert_array_equal(ctree.nodes_array, jtree.nodes_array)
    np.testing.assert_array_equal(ctree.inds_array, jtree.inds_array)

    # Root indices must be the output indices present in the network
    want_out = frozenset(output_inds).intersection(
        x for xs in ts_inds for x in xs)
    assert ctree.output_inds() == want_out == jtree.output_inds()

    # path() round trip: the reference's path; rebuilding from it gives
    # the same tree-cost (tree shape may renumber, cost is the invariant).
    path2 = ctree.path()
    assert path2 == jtree.path()
    ctree2 = ContractionTree(path2, ts_inds, dims, output_inds=output_inds,
                             check_shared_inds=True)
    assert ctree2.total_cost_exact() == ctree.total_cost_exact() == \
        jtree.total_cost_exact()
    assert ctree2.output_inds() == ctree.output_inds()

    # Exact costs and log2 total vs the oracles of both packages
    assert tu.exact_contraction_costs(ctree) == \
        jtu.exact_contraction_costs(jtree)
    assert tu.exact_log2_total(ctree) == jtu.exact_log2_total(jtree)
    assert tu.exact_log2_total(ctree) == pytest.approx(
        np.log2(float(ctree.total_cost_exact())), rel=1e-12)


def test_ctree_requires_output_inds_for_hyper():
    ts_inds = [['i', 'j'], ['i', 'j'], ['i', 'k']]
    with pytest.raises(ValueError):
        ContractionTree([(0, 1), (0, 1)], ts_inds, 2)
    _same_raise(ContractionTree, JContractionTree, [(0, 1), (0, 1)],
                ts_inds, 2)


def test_get_contraction_postorder():
    path = [(0, 1), (0, 1)]
    ts = [['a', 'b'], ['b', 'c'], ['c', 'd']]
    ctree = ContractionTree(path, ts, 2)
    contraction = get_contraction(ctree)
    assert len(contraction) == 2
    # Children appear before parents
    seen = set(range(ctree.n_leaves))
    for c0, c1, out in contraction:
        assert c0 in seen and c1 in seen
        seen.add(out)
    assert contraction[-1][2] == len(ctree) - 1
    assert contraction == jget_contraction(JContractionTree(path, ts, 2))


@pytest.mark.parametrize('hyper', [False, True])
@pytest.mark.parametrize('rep', range(4))
def test_max_width_and_log2_costs(rep, hyper, rng, random_seed):
    """``max_width()`` and ``contraction_log2_costs()`` bitwise the
    reference's; -inf on exactly the leaves; exp2 of each internal entry
    the exact cost within float64 rounding."""
    _, ctree, jtree = _random_pair(rng, random_seed, hyper)
    assert ctree.max_width() == jtree.max_width()
    got, want = ctree.contraction_log2_costs(), jtree.contraction_log2_costs()
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))
    leaves = ctree.nodes_array[:, 0] < 0
    assert np.all(np.isneginf(got[leaves])) and np.isfinite(got[~leaves]).all()
    exact = tu.exact_contraction_costs(ctree)
    for g, c, leaf in zip(got, exact, leaves):
        if not leaf:
            assert g == pytest.approx(np.log2(c), rel=1e-12)
    # A tree without indices (scalars) has width 0 in both packages.
    scalars = [(), ()]
    assert ContractionTree([(0, 1)], scalars, 2).max_width() == \
        JContractionTree([(0, 1)], scalars, 2).max_width()


@pytest.mark.parametrize('rep', range(4))
def test_swap_with_nn(rep, rng, random_seed):
    """The same moves give the same ``nodes_array`` in both packages, at
    every position (leaves, top nodes and the root included, and past the
    end: no-ops); swapping a node back with its old uncle restores the
    tree; the moved structure's path builds a valid tree of the cost the
    reference finds for it."""
    (ts_inds, output_inds, dims), ctree, jtree = _random_pair(
        rng, random_seed, min_n_tensors=6)
    n = len(ctree)
    for _ in range(3 * n):
        pos = rng.randrange(n + 2)
        ctree.swap_with_nn(pos)
        jtree.swap_with_nn(pos)
        np.testing.assert_array_equal(ctree.nodes_array, jtree.nodes_array)
    start = ctree.nodes_array.copy()
    nodes = ctree.nodes_array
    movable = [d for d in range(n) if nodes[d, 2] >= 0 and
               nodes[nodes[d, 2], 2] >= 0]
    assert movable
    for d in movable:
        b = nodes[d, 2]
        a = nodes[b, 2]
        c = nodes[a, 1] if nodes[a, 0] == b else nodes[a, 0]
        ctree.swap_with_nn(d)
        assert nodes[d, 2] == a and nodes[c, 2] == b
        path = ctree.path()
        assert path == jtree.replace_arrays(nodes.copy(),
                                            jtree.inds_array).path()
        moved = ContractionTree(path, ts_inds, dims, output_inds=output_inds)
        assert moved.is_valid()
        assert moved.total_cost_exact() == JContractionTree(
            path, ts_inds, dims, output_inds=output_inds).total_cost_exact()
        ctree.swap_with_nn(c)
        np.testing.assert_array_equal(ctree.nodes_array, start)


def test_traverse_tree(rng, random_seed):
    """Post-order, as the reference's: children before their parent, the
    root last, every node once."""
    _, ctree, jtree = _random_pair(rng, random_seed, True)
    got, want = [], []
    traverse_tree(ctree, got.append)
    jtraverse_tree(jtree, want.append, verbose=1)
    assert got == want and sorted(got) == list(range(len(ctree)))
    assert got[-1] == len(ctree) - 1
    done = set()
    for pos in got:
        c0, c1, _ = ctree.nodes_array[pos]
        assert c0 < 0 or (c0 in done and c1 in done)
        done.add(pos)


@pytest.mark.parametrize('sparse', [False, True])
def test_get_max_width(rng, random_seed, sparse):
    """``SimpleCostModel.get_max_width`` over the tree's index sets (and
    with slices removed) bitwise the reference's, dense and with sparse
    indices capped at log2(n_projs)."""
    (ts_inds, output_inds, dims), ctree, jtree = _random_pair(
        rng, random_seed, True)
    labels = sorted({x for xs in ts_inds for x in xs}, key=repr)
    kw = (dict(sparse_inds=frozenset(rng.sample(labels, 3)), n_projs=3)
          if sparse else {})
    cm, jcm = SimpleCostModel(3.0, **kw), JFWModel(3.0, **kw)
    sets = list(ctree.inds)
    assert sets == list(jtree.inds)
    assert cm.get_max_width(sets, dims) == jcm.get_max_width(sets, dims)
    if not sparse:
        assert cm.get_max_width(sets, dims) == pytest.approx(
            ctree.max_width(), rel=1e-12)
    else:
        assert cm.get_max_width(sets, dims) <= ctree.max_width() + 1e-12
    sliced = [xs - frozenset(labels[:2]) for xs in sets]
    assert cm.get_max_width(sliced, dims) == jcm.get_max_width(sliced, dims)
    _same_raise(cm.get_max_width, jcm.get_max_width, [], dims)


@pytest.mark.parametrize('shape', [(3,), (5, 2), (2, 3, 4), ()])
def test_any_bits_popcount(shape):
    """``any_bits`` and ``popcount`` over the lane axis bitwise the JAX
    package's ``jnp`` versions, on words with the sign bit, all bits and
    zero rows; numpy lanes and int32 tensors give the same."""
    rng = np.random.default_rng(sum(shape) + 7)
    lanes = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(
        np.uint32)
    if lanes.ndim:
        lanes.reshape(-1)[:1] = 0xFFFFFFFF
        lanes.reshape(-1)[1:2] = 0x80000000
        if lanes.ndim > 1:
            lanes[0] = 0
    t = torch.from_numpy(lanes.view(np.int32).copy())
    want_any = np.asarray(jbitops.any_bits(jnp.asarray(lanes)))
    for x in (t, lanes):
        got = bitops.any_bits(x)
        assert got.dtype == torch.bool and got.shape == want_any.shape
        np.testing.assert_array_equal(got.numpy(), want_any)
    if not shape:
        return
    want_pop = np.asarray(jbitops.popcount(jnp.asarray(lanes)))
    for x in (t, lanes):
        got = bitops.popcount(x)
        assert got.dtype == torch.int32 and want_pop.dtype == np.int32
        np.testing.assert_array_equal(got.numpy(), want_pop)
    bits = np.unpackbits(lanes.view(np.uint8), axis=-1)
    np.testing.assert_array_equal(want_pop, bits.sum(-1))

"""The port's ``utils/tn.py`` and ``utils/tensor.py`` against the JAX
package's: the counterpart of ``tests/test_utils.py``'s tests (hyper
counts, connected components, ``read_inds``, merged and split paths,
``fuse``, sliced and plain execution, ``tensordot``'s hyper semantics,
``is_diagonal``, ``svd``, einsum subscripts), each also run through the
reference on the same seeded inputs (``random.Random`` and numpy).

Tolerance: paths, index sets, dims and exceptions exactly; arrays within
1e-12 (relative, and absolute to the result's largest entry) of the
reference's, which runs the same numpy operations."""

import math

import numpy as np
import pytest

from tnco_tpu.testing import utils as jtu
from tnco_tpu.utils import tensor as jtensor
from tnco_tpu.utils import tn as jtn
from tnco_tpu_torch.testing.utils import generate_random_tensors
from tnco_tpu_torch.utils.tensor import (get_einsum_subscripts, is_diagonal,
                                         svd, tensordot)
from tnco_tpu_torch.utils.tn import (contract, contract_sliced, fuse,
                                     get_connected_components,
                                     get_einsum_subscripts as tn_subscripts,
                                     get_hyper_count,
                                     get_random_contraction_path,
                                     merge_contraction_paths, read_inds,
                                     split_contraction_path)
from torch_reference_native import reference_native  # noqa: F401

RTOL = 1e-12


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * max(1.0, np.abs(want).max()))


def _net(rng, **kwargs):
    """A random network from the port's generator, checked equal to the
    reference's for the same state of ``rng``."""
    state = rng.getstate()
    net = generate_random_tensors(rng, **kwargs)
    after = rng.getstate()
    rng.setstate(state)
    assert jtu.generate_random_tensors(rng, **kwargs) == net
    assert rng.getstate() == after
    return net


def _raises(fn, *args, **kwargs):
    try:
        fn(*args, **kwargs)
    except Exception as exc:  # noqa: BLE001 -- compared across packages
        return type(exc).__name__, str(exc)
    return None


def test_get_hyper_count():
    ts_inds = [('i', 'j'), ('j', 'k'), ('j', 'k')]
    hc = get_hyper_count(ts_inds)
    assert hc == {'i': 0, 'j': 2, 'k': 1} == jtn.get_hyper_count(ts_inds)
    hc = get_hyper_count(ts_inds, output_inds=('i', 'j'))
    assert hc == {'i': 1, 'j': 3, 'k': 1}
    assert hc == jtn.get_hyper_count(ts_inds, output_inds=('i', 'j'))


def test_connected_components(rng):
    ts_inds = [('a', 'b'), ('b',), ('x',), ('x', 'y'), ('z',)]
    cc = sorted(get_connected_components(ts_inds))
    assert cc == [(0, 1), (2, 3), (4,)]
    ts, _, _ = _net(rng, n_ccs=3, n_tensors=12)
    assert sorted(get_connected_components(ts)) == sorted(
        jtn.get_connected_components(ts))


def test_read_inds_tokens():
    rows = {0: (2, 't0', 't1'), 1: (3, 't1', '*'), 2: (4, 't0', '/')}
    tensor_map, dims, out, sparse = read_inds(rows)
    assert tensor_map == {'t0': (0, 2), 't1': (0, 1)}
    assert dims == {0: 2, 1: 3, 2: 4}
    assert out == frozenset({1}) and sparse == frozenset({2})
    assert (tensor_map, dims, out, sparse) == jtn.read_inds(rows)
    with pytest.raises(ValueError):
        read_inds(rows, output_index_token='*', sparse_index_token='*')
    kw = dict(output_index_token='*', sparse_index_token='*')
    assert _raises(read_inds, rows, **kw) == _raises(jtn.read_inds, rows,
                                                     **kw)


def test_merge_split_roundtrip(rng, random_seed):
    ts_inds, output_inds, dims = _net(rng, n_ccs=3, n_tensors=12,
                                      n_output_inds=1)
    paths = get_random_contraction_path(ts_inds, output_inds,
                                        merge_paths=False,
                                        seed=random_seed)
    assert paths == jtn.get_random_contraction_path(
        ts_inds, output_inds, merge_paths=False, seed=random_seed)
    merged = merge_contraction_paths(len(ts_inds), paths,
                                     autocomplete=False)
    assert merged == jtn.merge_contraction_paths(len(ts_inds), paths,
                                                 autocomplete=False)
    # Splitting the merged path recovers per-component paths
    split = split_contraction_path(len(ts_inds), merged)
    assert split == jtn.split_contraction_path(len(ts_inds), merged)
    nonempty = [p for p in paths if p]
    assert sorted(map(len, split)) == sorted(map(len, nonempty))
    # With autocomplete, contraction reaches a single tensor
    merged_full = merge_contraction_paths(len(ts_inds), paths)
    assert merged_full == jtn.merge_contraction_paths(len(ts_inds), paths)
    out_ts, out = contract(merged_full, ts_inds, output_inds, dims=dims)
    assert len(out_ts) == 1
    assert (out_ts, out) == jtn.contract(merged_full, ts_inds, output_inds,
                                         dims=dims)

    # Docstring examples (reference tn.py:357-360, 430-433)
    assert merge_contraction_paths(4, [[(0, 1)], [(2, 3)]]) == \
        [(0, 1), (0, 1), (0, 1)]
    assert split_contraction_path(4, [(0, 1), (0, 1)]) == \
        [[(0, 1)], [(2, 3)]]


def test_fuse_respects_width(rng, random_seed):
    ts_inds, output_inds, dims = _net(rng, n_output_inds=2, min_dim=2,
                                      max_dim=4)
    max_width = 4.0
    path, fused = fuse(ts_inds, dims, max_width, output_inds,
                       seed=random_seed, return_fused_inds=True)
    assert (path, fused) == jtn.fuse(ts_inds, dims, max_width, output_inds,
                                     seed=random_seed,
                                     return_fused_inds=True)
    for xs in fused:
        assert sum(math.log2(dims[x]) for x in xs) <= max_width + 1e-9
    # Replaying the path with contract() yields consistent index sets
    out_ts, out = contract(path, list(ts_inds), output_inds, dims=dims)
    assert frozenset(out) == frozenset(output_inds) & frozenset(
        x for xs in out_ts for x in xs)


def test_fuse_exclude_inds(random_seed):
    ts_inds = [('a', 'b'), ('b', 'c'), ('c', 'd')]
    dims = {x: 2 for x in 'abcd'}
    kw = dict(exclude_inds=('b',), seed=random_seed, return_fused_inds=True)
    path, fused = fuse(ts_inds, dims, 10.0, ('a', 'd'), **kw)
    assert (path, fused) == jtn.fuse(ts_inds, dims, 10.0, ('a', 'd'), **kw)
    # the only contractible index left is 'c'
    assert len(path) <= 1
    with pytest.raises(ValueError):
        fuse(ts_inds, dims, 4.0, exclude_inds=('zz',))
    assert _raises(fuse, ts_inds, dims, 4.0, exclude_inds=('zz',)) == \
        _raises(jtn.fuse, ts_inds, dims, 4.0, exclude_inds=('zz',))


def test_contract_sliced_matches_unsliced(rng, random_seed):
    # Random single-component network; slicing any subset of the
    # non-output indices and summing the projected passes must equal
    # the plain contraction (linearity), and the reference's execution.
    ts_inds, output_inds, dims = _net(
        rng, n_ccs=1, n_tensors=6, n_output_inds=2, n_hyper_edges=1,
        min_dim=2, max_dim=3)
    paths = get_random_contraction_path(ts_inds, output_inds,
                                        seed=random_seed)
    arrays = [
        np.asarray(rng.choices(range(-3, 4),
                               k=int(np.prod([dims[x] for x in xs]))),
                   dtype=float).reshape([dims[x] for x in xs])
        for xs in ts_inds
    ]
    ts_w, out_inds, (want,) = contract(paths, ts_inds, output_inds,
                                       arrays=list(arrays))
    jts_w, jout, (jwant,) = jtn.contract(paths, ts_inds, output_inds,
                                         arrays=list(arrays))
    assert (ts_w, out_inds) == (jts_w, jout)
    _close(want, jwant)
    sliceable = sorted(
        frozenset(x for xs in ts_inds for x in xs) - frozenset(output_inds),
        key=repr)
    slices = tuple(rng.sample(sliceable, k=min(2, len(sliceable))))
    ts_out, out_inds_s, (got,) = contract_sliced(paths, ts_inds, slices,
                                                 output_inds,
                                                 arrays=list(arrays))
    jts_out, _, (jgot,) = jtn.contract_sliced(paths, ts_inds, slices,
                                              output_inds,
                                              arrays=list(arrays))
    assert ts_out == jts_out
    _close(got, jgot)
    assert out_inds_s == out_inds and len(ts_out) == 1
    # Dropping sliced axes may permute the surviving output axes.
    got = np.transpose(np.asarray(got),
                       [ts_out[0].index(x) for x in ts_w[0]])
    _close(got, want)

    # Empty slice tuple degenerates to a single plain pass.
    _, _, (got0,) = contract_sliced(paths, ts_inds, (), output_inds,
                                    arrays=list(arrays))
    _close(got0, want)


def test_contract_sliced_hyper_and_errors():
    # Hyper index 'h' (3 tensors): slicing it must equal the einsum that
    # sums it.
    ts_inds = [('h', 'i'), ('h', 'i', 'j'), ('h', 'j')]
    rng_ = np.random.default_rng(7)
    arrays = [rng_.integers(-2, 3, size=(2,) * len(xs)).astype(float)
              for xs in ts_inds]
    path = [(0, 1), (0, 1)]
    want = np.einsum('hi,hij,hj->', *arrays)
    _, _, (got,) = contract_sliced(path, ts_inds, ('h',), (),
                                   arrays=list(arrays))
    _close(got, want)

    # Repeated in-tensor label: projection takes the diagonal element.
    ts2 = [('h', 'h', 'i'), ('i',)]
    arr2 = [rng_.integers(-2, 3, size=(2, 2, 2)).astype(float),
            rng_.integers(-2, 3, size=(2,)).astype(float)]
    _, _, (got2,) = contract_sliced([(0, 1)], ts2, ('h',), (),
                                    arrays=list(arr2))
    _close(got2, np.einsum('hhi,i->', *arr2))

    cases = [((path, ts_inds, ('i',), ('i',)), dict(arrays=list(arrays)),
              'output'),
             ((path, ts_inds, ('zz',), ()), dict(arrays=list(arrays)),
              'not in the network'),
             ((path, ts_inds, ('h',), ()), {}, 'arrays'),
             # Incomplete path leaves two tensors: the slice sum would not
             # distribute over their product.
             (([(0, 1)], ts_inds, ('h',), ()), dict(arrays=list(arrays)),
              'single tensor')]
    for args, kw, match in cases:
        with pytest.raises(ValueError, match=match):
            contract_sliced(*args, **kw)
        assert _raises(contract_sliced, *args, **kw) == \
            _raises(jtn.contract_sliced, *args, **kw)


def test_tensordot_hyper_semantics(rng):
    # hyper index 'h' survives as a batch dim
    x = np.asarray(rng.choices(range(1, 5), k=8),
                   dtype=float).reshape(2, 2, 2)
    y = np.asarray(rng.choices(range(1, 5), k=8),
                   dtype=float).reshape(2, 2, 2)
    z, zs = tensordot((x, ('h', 'i', 'j')), (y, ('h', 'j', 'k')),
                      hyper_inds=('h',))
    jz, jzs = jtensor.tensordot((x, ('h', 'i', 'j')), (y, ('h', 'j', 'k')),
                                hyper_inds=('h',))
    assert zs == jzs and frozenset(zs) == {'h', 'i', 'k'}
    _close(z, jz)
    z = np.asarray(z).transpose([zs.index(l) for l in ('h', 'i', 'k')])
    _close(z, np.einsum('hij,hjk->hik', x, y))

    # plain contraction
    z2, zs2 = tensordot((x, ('a', 'b', 'c')), (y, ('c', 'd', 'e')))
    jz2, jzs2 = jtensor.tensordot((x, ('a', 'b', 'c')), (y, ('c', 'd', 'e')))
    assert zs2 == jzs2 and frozenset(zs2) == {'a', 'b', 'd', 'e'}
    _close(z2, jz2)
    args = ((x, ('a', 'b', 'c')), (y, ('c', 'd', 'e')))
    with pytest.raises(ValueError):
        tensordot(*args, hyper_inds=('a',))
    assert _raises(tensordot, *args, hyper_inds=('a',)) == \
        _raises(jtensor.tensordot, *args, hyper_inds=('a',))
    # inds-only mode
    got = tensordot((None, ('a', 'b')), (None, ('b', 'c')),
                    return_inds_only=True)
    assert frozenset(got) == {'a', 'c'}
    assert got == jtensor.tensordot((None, ('a', 'b')), (None, ('b', 'c')),
                                    return_inds_only=True)


def test_is_diagonal_and_svd():
    for mod_is_diagonal in (is_diagonal, jtensor.is_diagonal):
        assert mod_is_diagonal(np.diag([1.0, 2.0]))
        assert not mod_is_diagonal(np.ones((2, 2)))
    with pytest.raises(ValueError):
        is_diagonal(np.ones(3))
    assert _raises(is_diagonal, np.ones(3)) == \
        _raises(jtensor.is_diagonal, np.ones(3))

    (u, u_inds), (s, s_inds), (vh, vh_inds) = svd(
        np.eye(2), ['i', 'j'], ['i'], svd_index_name='k')
    assert u_inds == ('i', 'k') and s_inds == ('k',)
    assert vh_inds == ('k', 'j')
    np.testing.assert_allclose(np.abs(s), [1.0, 1.0])
    # Truncation: rank-1 matrix keeps one singular value, as the
    # reference's does, with its values.
    m = np.outer([1.0, 2.0], [3.0, 4.0])
    got = svd(m, ['i', 'j'], ['i'], atol=1e-8, svd_index_name='k')
    want = jtensor.svd(m, ['i', 'j'], ['i'], atol=1e-8, svd_index_name='k')
    assert got[1][0].shape == (1,)
    for (a, ai), (b, bi) in zip(got, want):
        assert ai == bi
        _close(a, b)
    # Degenerate: no split requested
    [(arr, inds)] = svd(np.eye(2), ['i', 'j'], [])
    assert inds == ('i', 'j')


def test_subscripts():
    assert get_einsum_subscripts(['i', 'j'], ['j', 'k'], ['i', 'k']) == \
        'ab,bc->ac' == jtensor.get_einsum_subscripts(['i', 'j'], ['j', 'k'],
                                                     ['i', 'k'])
    s = tn_subscripts([('i', 'j'), ('j', 'k')], ('i', 'k'))
    assert s == 'ab,bc->ac' == jtn.get_einsum_subscripts(
        [('i', 'j'), ('j', 'k')], ('i', 'k'))

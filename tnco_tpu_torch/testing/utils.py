"""Random tensor-network generators, contraction-tree audits and
comparison helpers: the port's copy of ``tnco_tpu/testing/utils.py``
(the generators and audits, :23-228, give the same networks and verdicts
for the same seeds; ``assert_batches_identical``, :231-254, compares the
port's batches), and the mixed log2-dims table of the walker's card
timings."""

import functools as fts
import itertools as its
import math
import operator as op
from random import Random

import numpy as np
import torch

__all__ = ['assert_tensors_identical', 'assert_batches_identical',
           'mixed_log2d_table', 'generate_random_inds',
           'generate_random_tensors', 'is_valid_contraction_tree',
           'exact_contraction_costs', 'exact_log2_total']


def generate_random_inds(n: int, seed=None):
    """Random mixed-type index labels (strings and tuples).

    Reference behavior: tnco/testing/utils.py:139-180 (labels may be any
    hashable type; order must be deterministic).
    """
    rng = seed if isinstance(seed, Random) else Random(seed)
    labels = []
    for i in range(n):
        match rng.randrange(3):
            case 0:
                labels.append(f'x{i}')
            case 1:
                labels.append((i, rng.randrange(100)))
            case _:
                labels.append(('idx', i))
    return labels


def generate_random_tensors(seed=None,
                            *,
                            n_tensors: int | None = None,
                            min_n_tensors: int = 4,
                            max_n_tensors: int = 12,
                            min_dim: int = 2,
                            max_dim: int = 4,
                            n_extra_edges: int | None = None,
                            n_hyper_edges: int = 0,
                            n_output_inds: int = 0,
                            n_hyper_output_inds: int = 0,
                            n_ccs: int = 1,
                            use_mixed_labels: bool = True):
    """Random connected (per-component) tensor network.

    Returns:
        ``(ts_inds, output_inds, dims)`` with ``ts_inds`` a list of label
        tuples, ``output_inds`` a frozenset, and ``dims`` a dict.
    """
    rng = seed if isinstance(seed, Random) else Random(seed)
    if n_tensors is None:
        n_tensors = rng.randint(min_n_tensors, max_n_tensors)
    n_tensors = max(n_tensors, n_ccs)

    # Assign tensors to components (each non-empty)
    comp_of = list(range(n_ccs)) + [
        rng.randrange(n_ccs) for _ in range(n_tensors - n_ccs)
    ]
    rng.shuffle(comp_of)
    comps = [[t for t in range(n_tensors) if comp_of[t] == c]
             for c in range(n_ccs)]

    ts_inds = [[] for _ in range(n_tensors)]
    next_label = its.count()
    label_pool = []

    def new_label():
        i = next(next_label)
        if use_mixed_labels:
            label = generate_random_inds(1, rng)[0]
            label = (label, i)  # ensure uniqueness
        else:
            label = f'i{i}'
        label_pool.append(label)
        return label

    # Spanning structure per component
    for comp in comps:
        for k, t in enumerate(comp[1:], start=1):
            s = rng.choice(comp[:k])
            x = new_label()
            ts_inds[s].append(x)
            ts_inds[t].append(x)

    # Extra pairwise edges
    if n_extra_edges is None:
        n_extra_edges = rng.randint(0, n_tensors)
    for _ in range(n_extra_edges):
        comp = comps[rng.randrange(n_ccs)]
        if len(comp) < 2:
            continue
        s, t = rng.sample(comp, k=2)
        x = new_label()
        ts_inds[s].append(x)
        ts_inds[t].append(x)

    # Hyper edges (same index on >= 3 tensors)
    for _ in range(n_hyper_edges):
        comp = comps[rng.randrange(n_ccs)]
        if len(comp) < 3:
            continue
        k = rng.randint(3, min(len(comp), 5))
        x = new_label()
        for t in rng.sample(comp, k=k):
            ts_inds[t].append(x)

    # Dangling output indices (appear in exactly one tensor)
    output_inds = set()
    for _ in range(n_output_inds):
        t = rng.randrange(n_tensors)
        x = new_label()
        ts_inds[t].append(x)
        output_inds.add(x)

    # Hyper output indices (shared AND output)
    for _ in range(n_hyper_output_inds):
        comp = comps[rng.randrange(n_ccs)]
        if len(comp) < 2:
            continue
        k = rng.randint(2, min(len(comp), 4))
        x = new_label()
        for t in rng.sample(comp, k=k):
            ts_inds[t].append(x)
        output_inds.add(x)

    # Make sure every tensor has at least one index
    for t in range(n_tensors):
        if not ts_inds[t]:
            x = new_label()
            ts_inds[t].append(x)
            output_inds.add(x)

    dims = {x: rng.randint(min_dim, max_dim) for x in label_pool}
    return ([tuple(xs) for xs in ts_inds], frozenset(output_inds), dims)


def exact_contraction_costs(ctree) -> list[int]:
    """Exact per-node contraction costs (Python bigints); leaves are 0.

    Independent oracle for the device CostCache
    (infinite_memory/utils.hpp:22-66): cost = prod dims over ``in1 | in2``.
    """
    dims = ctree.dims
    inds = ctree.inds
    costs = []
    for pos, node in enumerate(ctree.nodes):
        if node.is_leaf():
            costs.append(0)
        else:
            union = inds[node.children[0]] | inds[node.children[1]]
            costs.append(
                fts.reduce(op.mul, (dims[x] for x in union), 1))
    return costs


def exact_log2_total(ctree) -> float:
    """log2 of the exact total cost; -inf for a single-leaf tree."""
    total = sum(exact_contraction_costs(ctree))
    if total == 0:
        return -math.inf
    return math.log2(total)


def is_valid_contraction_tree(ctree,
                              ts_inds=None,
                              output_inds=None,
                              dims=None,
                              *,
                              check_shared_inds: bool = True) -> bool:
    """Full audit: structure, contraction rules, hyper-count, pickle.

    Reference: tnco/testing/utils.py:362-445.
    """
    import pickle

    ok, msg = ctree.is_valid(check_shared_inds=check_shared_inds,
                             return_message=True)
    if not ok:
        raise AssertionError(msg)

    # Pickle round-trip must be exact
    other = pickle.loads(pickle.dumps(ctree))
    assert other == ctree

    # Hyper-count audit: replay the contraction from the leaves
    if ts_inds is not None:
        from tnco_tpu_torch.utils.tn import get_hyper_count
        from tnco_tpu_torch.ctree import get_contraction

        inds = ctree.inds
        n_leaves = ctree.n_leaves
        leaf_inds = [frozenset(inds[i]) for i in range(n_leaves)]
        hyper_count = get_hyper_count(
            (tuple(xs) for xs in leaf_inds),
            output_inds=(frozenset(output_inds).intersection(
                its.chain.from_iterable(leaf_inds))
                         if output_inds is not None else None))

        for c0, c1, out in get_contraction(ctree):
            ix, iy = frozenset(inds[c0]), frozenset(inds[c1])
            iz = ix ^ iy
            for x in ix & iy:
                assert hyper_count[x] > 0
                hyper_count[x] -= 1
                if hyper_count[x] > 0:
                    iz |= {x}
            assert iz == frozenset(inds[out]), (
                f'node {out}: expected {iz}, got {frozenset(inds[out])}')

    # Dims audit
    if dims is not None:
        try:
            d = int(dims)
            assert all(v == d for v in ctree.dims.values())
        except (TypeError, ValueError):
            assert all(dims[x] == v for x, v in ctree.dims.items())
    return True


_TOTALS = ('log2_total', 'min_log2_total')


def _bits(x):
    a = x.detach().cpu().numpy()
    return a.view(f'<u{a.dtype.itemsize}') if a.dtype.kind == 'f' else a


def assert_tensors_identical(ref, got, what=''):
    """Same dtype, shape and bits (floats compared as their words, so NaN
    payloads and the sign of zero count)."""
    if ref.dtype != got.dtype:
        raise AssertionError(f'{what}: dtype {got.dtype} != {ref.dtype}')
    np.testing.assert_array_equal(_bits(got), _bits(ref), err_msg=what)


def assert_batches_identical(ref, got, *, total_rtol=3e-7):
    """Cross-engine batch equality: exact state, ulp-tolerant totals.

    Every field of two batches of one class (``SABatch`` or
    ``SABatchFW``) is compared bitwise, except the derived totals
    ``log2_total`` and ``min_log2_total``, which pass through
    ``exp2``/``log2`` and are compared to ``total_rtol`` (about 2 ulp),
    as the JAX package's helper does.
    """
    if type(ref) is not type(got):
        raise AssertionError(f'{type(got).__name__} != {type(ref).__name__}')
    for name in type(ref).field_names():
        a, b = getattr(ref, name), getattr(got, name)
        if name in _TOTALS:
            np.testing.assert_allclose(b.cpu().numpy(), a.cpu().numpy(),
                                       rtol=total_rtol, atol=0, err_msg=name)
        else:
            assert_tensors_identical(a, b, name)


def mixed_log2d_table(log2d_w32, seed=0):
    """A ``[W, 32]`` log2-dims table of the same shape as ``log2d_w32``
    with mixed dims (log2 of 2 to 5, drawn from ``seed``) where it has an
    index and 0 elsewhere: the walker kernel's tree width route on a
    state whose own dims take its popcount route."""
    rng = np.random.default_rng(seed)
    d = rng.integers(2, 6, log2d_w32.numel()).astype(np.float32)
    mixed = torch.from_numpy(np.log2(d)).to(log2d_w32.device)
    return torch.where(log2d_w32.reshape(-1) != 0, mixed,
                       0.0).reshape(log2d_w32.shape).contiguous()

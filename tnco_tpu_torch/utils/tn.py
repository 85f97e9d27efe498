"""Tensor-network graph utilities (the port's copy of
``tnco_tpu/utils/tn.py``).

Hyper-counts, connected components, randomized greedy initial paths,
path merge/split, the index-map text format, tensor fusion, and a
contraction executor with hyper-index semantics, also over slices
(reference tnco/utils/tn.py:39-1070).  The greedy paths come from the
port's own copy of opt_einsum's greedy (:mod:`tnco_tpu_torch.utils.greedy`),
so no ``opt_einsum`` is needed.
"""

from bisect import bisect_left
from collections import Counter, defaultdict
from collections.abc import Iterable
import functools as fts
import itertools as its
import math
import operator as op
from random import Random

from tnco_tpu_torch.ordered_frozenset import OrderedFrozenSet
from tnco_tpu_torch.utils.greedy import greedy_path

__all__ = [
    'get_random_contraction_path', 'get_symbol', 'get_einsum_subscripts',
    'read_inds', 'fuse', 'decompose_hyper_inds', 'merge_contraction_paths',
    'split_contraction_path', 'contract', 'contract_sliced',
    'get_hyper_count',
    'get_connected_components'
]


def get_connected_components(ts_inds, verbose: int = 0):
    """Union-find over shared indices; returns sorted tensor-id tuples.

    Reference: tnco/utils/tn.py:61-106.
    """
    del verbose
    ts_inds = list(ts_inds)
    n = len(ts_inds)
    parent = list(range(n))

    def find(i):
        root = i
        while parent[root] != root:
            root = parent[root]
        while parent[i] != root:
            parent[i], i = root, parent[i]
        return root

    def union(i, j):
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[max(ri, rj)] = min(ri, rj)

    index_owner = {}
    for t, inds in enumerate(ts_inds):
        for x in inds:
            if x in index_owner:
                union(t, index_owner[x])
            else:
                index_owner[x] = t

    components = defaultdict(list)
    for t in range(n):
        components[find(t)].append(t)
    return [tuple(sorted(c)) for c in components.values()]


def get_hyper_count(ts_inds, output_inds=None):
    """#occurrences - 1 per index, +1 if an output index.

    Reference: tnco/utils/tn.py:572-595.
    """
    flat = its.chain.from_iterable(ts_inds)
    hyper_count = {x: n - 1 for x, n in Counter(flat).items()}
    if output_inds is not None:
        for x in output_inds:
            hyper_count[x] = hyper_count.get(x, 0) + 1
    return hyper_count


def get_symbol(i: int) -> str:
    """Unique unicode einsum symbol for integer ``i``.

    Reference: tnco/utils/tn.py:276-300 (surrogate range skipped).
    """
    if i < 52:
        return 'abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ'[i]
    if i >= 55296:
        return chr(i + 2048)
    return chr(i + 140)


def get_einsum_subscripts(ts_inds, output_inds=()):
    """Einsum subscripts string for the given index lists.

    Reference: tnco/utils/tn.py:303-331.
    """
    ts_inds = list(ts_inds)
    output_inds = list(output_inds)
    uniq = dict.fromkeys(its.chain(its.chain.from_iterable(ts_inds),
                                   output_inds))
    inds_map = {x: get_symbol(i) for i, x in enumerate(uniq)}
    return ','.join(''.join(inds_map[x] for x in xs)
                    for xs in ts_inds) + '->' + ''.join(
                        inds_map[x] for x in output_inds)


def get_random_contraction_path(ts_inds,
                                output_inds,
                                *,
                                merge_paths: bool = True,
                                autocomplete: bool = True,
                                seed: int | None = None,
                                verbose: int = 0,
                                **kwargs):
    """Random initial contraction path via the greedy path finder.

    Per-connected-component greedy path over a shuffled tensor order, with
    connecting hyper-indices removed from the output set so that only
    tensors sharing at least one index are paired (reference
    tnco/utils/tn.py:109-273, see its Notes for the hyper-output rationale).

    Returns one merged linear path, or one linear path per connected
    component when ``merge_paths=False``.
    """
    _return_contraction = kwargs.pop('_return_contraction', False)
    if kwargs:
        raise TypeError("Got an unexpected keyword argument(s).")
    del verbose

    rng = Random(seed)
    ts_inds = list(ts_inds)
    n_tensors = len(ts_inds)

    output_inds_set = OrderedFrozenSet(output_inds)
    hyper_count = get_hyper_count(ts_inds, output_inds=output_inds_set)
    filtered_output_inds = OrderedFrozenSet(
        x for x in output_inds_set if hyper_count.get(x, 0) <= 1)

    components = get_connected_components(ts_inds)

    paths = []
    next_id = n_tensors
    for cc in components:
        if len(cc) <= 1:
            paths.append([])
            continue

        cc_list = list(cc)
        rng.shuffle(cc_list)

        ts_inds_cc = [ts_inds[i] for i in cc_list]
        output_inds_cc = filtered_output_inds.intersection(
            its.chain.from_iterable(ts_inds_cc))

        subscripts = get_einsum_subscripts(ts_inds_cc, output_inds_cc)
        linear_path_cc = greedy_path(subscripts, 2)

        # Local linear steps -> absolute contraction triples
        loc = list(cc_list)
        path_cc = []
        for px, py in linear_path_cc:
            px, py = sorted((px, py))
            ty = loc.pop(py)
            tx = loc.pop(px)
            tz = next_id
            next_id += 1
            loc.append(tz)
            path_cc.append((tx, ty, tz))
        paths.append(path_cc)

    if _return_contraction:
        return paths

    # Back to global linear einsum order
    linear_paths = []
    for path in paths:
        linear_path = []
        loc = list(range(n_tensors))
        for x, y, z in path:
            px, py = sorted(bisect_left(loc, t) for t in (x, y))
            loc.pop(py)
            loc.pop(px)
            loc.append(z)
            linear_path.append((px, py))
        linear_paths.append(linear_path)

    if merge_paths:
        return merge_contraction_paths(n_tensors, linear_paths,
                                       autocomplete=autocomplete)
    return linear_paths


def merge_contraction_paths(n_tensors: int,
                            paths,
                            *,
                            autocomplete: bool = True,
                            verbose: int = 0):
    """Merges per-component linear paths into one linear path.

    Reference: tnco/utils/tn.py:334-401.
    """
    del verbose
    merged_pos = list(range(n_tensors))
    merged_path = []

    for i, path in enumerate(paths):
        pos = list(range(n_tensors))
        for x, y in path:
            x, y = sorted((x, y))
            y = pos.pop(y)
            x = pos.pop(x)
            pos.append((i, len(pos)))
            try:
                mx, my = sorted((merged_pos.index(x), merged_pos.index(y)))
            except ValueError as e:
                raise ValueError(
                    "'paths' are not valid or not disconnected.") from e
            merged_path.append((mx, my))
            merged_pos.pop(my)
            merged_pos.pop(mx)
            merged_pos.append(pos[-1])

    if autocomplete:
        merged_path += [(0, 1)] * (len(merged_pos) - 1)
    return merged_path


def split_contraction_path(n_tensors: int,
                           path,
                           return_connected_components: bool = False,
                           normalize_paths: bool = False,
                           verbose: int = 0):
    """Splits a linear path into per-connected-component paths.

    Reference: tnco/utils/tn.py:404-517.
    """
    del verbose
    path = list(path)

    tensors = list(range(n_tensors))
    connectivity = [[] for _ in range(n_tensors + len(path) + 1)]
    n_intermediate = n_tensors
    for i, (x, y) in enumerate(map(sorted, path)):
        n_intermediate += 1
        t_y = tensors.pop(y)
        t_x = tensors.pop(x)
        connectivity[t_x].append(i)
        connectivity[t_y].append(i)
        connectivity[n_intermediate].append(i)
        tensors.append(n_intermediate)

    cc = [
        c for c in get_connected_components(connectivity)
        if list(c) != [n_tensors]
    ]

    tensors = list(range(n_tensors))
    cc_tensors = ([sorted(c) for c in cc] if normalize_paths else
                  [list(range(n_tensors)) for _ in cc])
    paths = [[] for _ in cc]

    n_intermediate = n_tensors
    for x, y in map(sorted, path):
        n_intermediate += 1
        t_x, t_y = tensors[x], tensors[y]
        cc_loc = next(i for i, s in enumerate(cc) if t_x in s)
        assert t_y in cc[cc_loc]
        tensors.pop(y)
        tensors.pop(x)
        tensors.append(n_intermediate)
        lx, ly = sorted(
            (cc_tensors[cc_loc].index(t_x), cc_tensors[cc_loc].index(t_y)))
        paths[cc_loc].append((lx, ly))
        cc_tensors[cc_loc].pop(ly)
        cc_tensors[cc_loc].pop(lx)
        cc_tensors[cc_loc].append(n_intermediate)

    if return_connected_components:
        cc = [frozenset(t for t in s if t < n_tensors) for s in cc]
        return paths, cc
    return [p for p in paths if p]


def read_inds(inds_map,
              *,
              output_index_token='*',
              sparse_index_token='/'):
    """Parses the index-map format: index -> (dim, tensor names...).

    Reference: tnco/utils/tn.py:520-569.

    Examples:
        >>> from tnco_tpu_torch.utils.tn import read_inds
        >>> # Row per index: (dim, owning tensors); '*' marks outputs.
        >>> tmap, dims, out, sparse = read_inds(
        ...     {'i': (2, 'A', 'B'), 'j': (4, 'B', '*')})
        >>> tmap == {'A': ('i',), 'B': ('i', 'j')}
        True
        >>> dims == {'i': 2, 'j': 4} and set(out) == {'j'}
        True
    """
    if output_index_token == sparse_index_token:
        raise ValueError(
            "'output_index_token' and 'sparse_index_token' must differ.")

    tensor_map = defaultdict(list)
    dims = {}
    for index, (dim, *names) in inds_map.items():
        dims[index] = int(dim)
        for name in names:
            tensor_map[name].append(index)

    output_inds = frozenset(tensor_map.pop(output_index_token, ()))
    sparse_inds = frozenset(tensor_map.pop(sparse_index_token, ()))
    return (dict((name, tuple(inds)) for name, inds in tensor_map.items()),
            dims, output_inds, sparse_inds)


def fuse(ts_inds,
         dims,
         max_width: float,
         output_inds=None,
         *,
         exclude_inds: Iterable = (),
         seed: int | None = None,
         return_fused_inds: bool = False,
         verbose: int = 0):
    """Randomized pre-contraction of tensors up to ``max_width``.

    Repeatedly picks a random contractible index and contracts two of its
    tensors when the fused width stays within ``max_width``, with full
    hyper-index bookkeeping (reference tnco/utils/tn.py:598-824).

    Returns the fusion path in linear (einsum) format (optionally with the
    fused index tuples).
    """
    del verbose
    rng = Random(seed)
    ts_inds = dict(enumerate(map(tuple, ts_inds)))

    all_tensors_inds = OrderedFrozenSet(
        dict.fromkeys(its.chain.from_iterable(ts_inds.values())))

    exclude_inds = frozenset(exclude_inds)
    if not exclude_inds.issubset(all_tensors_inds):
        raise ValueError("'exclude_inds' contains indices not in 'ts_inds'.")

    try:
        dims = dict(zip(all_tensors_inds, its.repeat(int(dims))))
    except (TypeError, ValueError):
        dims = dict(dims)
    if not frozenset(all_tensors_inds).issubset(dims):
        raise ValueError("'dims' is missing some indices.")

    def get_width(xs):
        return sum(math.log2(dims[x]) for x in xs)

    hyper_count = get_hyper_count(ts_inds.values())

    if output_inds is None:
        if any(c > 1 for c in hyper_count.values()):
            raise ValueError("'output_inds' must be provided if 'ts_inds' "
                             "has hyper-indices.")
        output_inds = (x for x, c in hyper_count.items() if c == 0)
    output_inds = frozenset(output_inds)
    if not output_inds.issubset(
            its.chain.from_iterable(ts_inds.values())):
        raise ValueError("'output_inds' is not consistent with 'ts_inds'.")

    # index -> set of tensor ids containing it
    index2tensors = defaultdict(set)
    for t, xs in ts_inds.items():
        for x in xs:
            index2tensors[x].add(t)
    index2tensors = dict(index2tensors)

    avail_inds = list(all_tensors_inds - exclude_inds - frozenset(
        x for x, c in hyper_count.items() if c == 0))

    t_idx = len(ts_inds)
    all_merged_inds = set()
    all_merged_tensors = []

    while avail_inds:
        index = avail_inds.pop(rng.randrange(len(avail_inds)))
        if not hyper_count.get(index):
            continue

        px, py = rng.sample(tuple(index2tensors[index]), k=2)
        tx, ty = ts_inds[px], ts_inds[py]
        all_inds = frozenset(tx) | frozenset(ty)
        if all_inds & exclude_inds:
            continue

        shared_inds = frozenset(tx) & frozenset(ty)
        assert index in shared_inds

        hyper_inds = frozenset(x for x in shared_inds
                               if hyper_count[x] > 1)
        tz = (frozenset(tx) ^ frozenset(ty)) | hyper_inds | (output_inds &
                                                             all_inds)
        # Keep the order of appearance in tx then ty
        tz = tuple(
            dict.fromkeys(
                its.chain((x for x in tx if x in tz),
                          (y for y in ty if y in tz))))

        if get_width(tz) > max_width:
            continue

        for x in shared_inds:
            hyper_count[x] -= 1
        for x in tz:
            index2tensors[x] -= {px, py}
            index2tensors[x] |= {t_idx}
        for x in (shared_inds - hyper_inds - output_inds):
            del index2tensors[x]

        all_merged_inds |= shared_inds
        del ts_inds[px]
        del ts_inds[py]
        ts_inds[t_idx] = tz
        t_idx += 1

        if hyper_count.get(index):
            avail_inds.append(index)
        all_merged_tensors.append((px, py, tz))

    assert not all_merged_inds & exclude_inds
    assert all(c >= 0 for c in hyper_count.values())

    # Renormalize to linear path format
    path = []
    fused_inds = []
    positions = list(range(t_idx))
    for px, py, tz in all_merged_tensors:
        px, py = sorted((px, py))
        py = positions.index(py)
        del positions[py]
        px = positions.index(px)
        del positions[px]
        if px > py:
            px, py = py, px
        path.append((px, py))
        fused_inds.append(tz)

    return (path, fused_inds) if return_fused_inds else path


def decompose_hyper_inds(arrays, ts_inds, *, atol: float = 1e-8):
    """Decomposes diagonal tensors into hyper-indices (TN level).

    Reference: tnco/utils/tn.py:827-903 — per-tensor decomposition followed
    by a color-merge of indices identified as equal.
    """
    from tnco_tpu_torch.utils import tensor as tensor_utils

    ts_inds = list(ts_inds)
    all_inds = OrderedFrozenSet(its.chain.from_iterable(ts_inds))

    new_arrays = []
    new_ts_inds = []
    new_hyper_inds = []
    for array, inds in zip(arrays, ts_inds):
        (new_array, new_inds), hyper_inds = tensor_utils.decompose_hyper_inds(
            array, inds, atol=atol)
        new_arrays.append(new_array)
        new_ts_inds.append(new_inds)
        new_hyper_inds.append(hyper_inds)

    # Color-merge identified indices
    index2color = {x: i for i, x in enumerate(all_inds)}
    color2inds = {c: OrderedFrozenSet([x]) for x, c in index2color.items()}

    for hyper_map in new_hyper_inds:
        for hyper_x, xs in hyper_map.items():
            if len(xs):
                group = frozenset(xs).union([hyper_x])
                cs = sorted(dict.fromkeys(index2color[x] for x in group))
                merged = fts.reduce(op.or_,
                                    (color2inds.pop(c) for c in cs))
                color2inds[cs[0]] = merged
                for x in merged:
                    index2color[x] = cs[0]

    hyper_inds_map = {}
    for xs in color2inds.values():
        first = next(iter(xs))
        for x in xs:
            hyper_inds_map[x] = first

    new_ts_inds = [tuple(hyper_inds_map[x] for x in xs)
                   for xs in new_ts_inds]
    return new_arrays, new_ts_inds, hyper_inds_map


def contract(path,
             ts_inds,
             output_inds=None,
             arrays=None,
             dims=None,
             *,
             backend=None,
             verbose: int = 0):
    """Reference contraction executor along a path with hyper semantics.

    Reference: tnco/utils/tn.py:906-1070.  Returns ``(ts_inds, output_inds)``
    or ``(ts_inds, output_inds, arrays)``.
    """
    from tnco_tpu_torch.utils import tensor as tensor_utils

    del verbose
    if dims is None and arrays is None:
        raise ValueError("Either 'dims' or 'arrays' must be provided.")

    ts_inds = [tuple(xs) for xs in ts_inds]

    if dims is not None:
        try:
            dims = dict(
                zip(its.chain.from_iterable(ts_inds),
                    its.repeat(int(dims))))
        except (ValueError, TypeError):
            pass

    if arrays is not None:
        arrays = [tensor_utils.asarray(a, like=backend) for a in arrays]
        dims_ = dict(
            its.chain.from_iterable(
                zip(xs, a.shape) for a, xs in zip(arrays, ts_inds)))
        if len(arrays) != len(ts_inds) or not all(
                tuple(a.shape) == tuple(dims_[x] for x in xs)
                for a, xs in zip(arrays, ts_inds)):
            raise ValueError("'ts_inds' is not consistent with 'arrays'.")
        if dims is None:
            dims = dims_
        elif not all(dims[x] == d for x, d in dims_.items()):
            raise ValueError("'dims' and 'arrays' are not compatible.")
    elif not frozenset(dims).issuperset(its.chain.from_iterable(ts_inds)):
        raise ValueError("'ts_inds' has indices not in 'dims'.")

    hyper_count = get_hyper_count(ts_inds)
    if output_inds is None:
        if any(c > 1 for c in hyper_count.values()):
            raise ValueError("'output_inds' must be provided if 'ts_inds' "
                             "has hyper-indices.")
        output_inds = (x for x, c in hyper_count.items() if c == 0)
    output_inds = frozenset(output_inds)
    if not output_inds.issubset(its.chain.from_iterable(ts_inds)):
        raise ValueError("'output_inds' is not consistent with 'ts_inds'.")

    for x, y in map(sorted, path):
        if x == y:
            raise ValueError("'path' is not valid.")
        ys = ts_inds.pop(y)
        xs = ts_inds.pop(x)
        if arrays is not None:
            ay = arrays.pop(y)
            ax = arrays.pop(x)

        shared_inds = frozenset(xs) & frozenset(ys)
        assert all(hyper_count[i] > 0 for i in shared_inds)
        hyper_inds = frozenset(
            i for i in shared_inds
            if hyper_count[i] > 1) | (output_inds & shared_inds)
        for i in shared_inds:
            hyper_count[i] -= 1

        if arrays is None:
            zs = tensor_utils.tensordot((None, xs), (None, ys),
                                        hyper_inds=hyper_inds,
                                        return_inds_only=True)
        else:
            az, zs = tensor_utils.tensordot((ax, xs), (ay, ys),
                                            hyper_inds=hyper_inds)
            arrays.append(az)
        ts_inds.append(zs)

    output_inds = output_inds.intersection(
        its.chain.from_iterable(ts_inds))
    if arrays is None:
        return ts_inds, output_inds
    return ts_inds, output_inds, arrays


def contract_sliced(path,
                    ts_inds,
                    slices,
                    output_inds=(),
                    arrays=None,
                    *,
                    backend=None):
    """Executes a SLICED contraction: sum over every assignment of the
    sliced indices of the projected network contracted along ``path``.

    This is the executable meaning of the finite-width cost model
    (every contraction repeats per slice assignment,
    include/tnco/optimize/finite_width/cost_model/simple.hpp:139-144):
    for each value of the sliced indices, every tensor containing one
    is projected onto that value, the projected network is contracted
    along the SAME path, and the scalar/array results are summed.
    The reference never executes sliced contractions (its finite-width
    sampler raises NotImplementedError, tnco/app/circuit/
    sampling.py:479-481) — this extends it.

    Sliced indices must not be output indices (an output slice would
    concatenate, not sum).  Returns ``(ts_inds, output_inds, arrays)``
    like :func:`contract` with arrays.
    """
    import numpy as _np

    if arrays is None:
        raise ValueError("'arrays' must be provided.")
    slices = tuple(dict.fromkeys(slices))
    output_inds = frozenset(output_inds)
    if output_inds & set(slices):
        raise ValueError("Sliced indices cannot be output indices.")
    ts_inds = [tuple(xs) for xs in ts_inds]
    dims = {}
    for xs, a in zip(ts_inds, arrays):
        for x, d in zip(xs, _np.shape(a)):
            dims[x] = d
    missing = [x for x in slices if x not in dims]
    if missing:
        raise ValueError(f'Sliced indices not in the network: {missing}')

    total = None
    out_inds_final = None
    ts_out = None
    for assignment in its.product(*(range(dims[x]) for x in slices)):
        proj_inds = []
        proj_arrays = []
        for xs, a in zip(ts_inds, arrays):
            for x, v in zip(slices, assignment):
                while x in xs:  # repeated label = in-tensor diagonal
                    k = xs.index(x)
                    a = _np.take(_np.asarray(a), v, axis=k)
                    xs = xs[:k] + xs[k + 1:]
            proj_inds.append(xs)
            proj_arrays.append(a)
        ts_out, out_inds_final, out_arrays = contract(
            path, proj_inds, output_inds=output_inds,
            arrays=proj_arrays, backend=backend)
        if len(out_arrays) != 1:
            # Summing per-tensor terms is only exact (linearity) when the
            # path reduces the projected network to ONE tensor: a product
            # of >=2 slice-dependent tensors does not distribute over the
            # slice sum.
            raise ValueError(
                "'path' must contract the network to a single tensor "
                f"(got {len(out_arrays)}).")
        term = out_arrays[0]
        total = term if total is None else total + term
    return ts_out, out_inds_final, [total]

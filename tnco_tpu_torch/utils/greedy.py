"""Greedy contraction-path finder (opt_einsum 3.4.0's ``greedy``).

The initial paths of every optimization come from
``opt_einsum.contract_path(..., optimize='greedy')`` in the reference
package.  The machine the port runs on has no ``opt_einsum``, so this
module carries a copy of the part that call runs: ``contract_path``'s
trivial cases, ``paths.ssa_greedy_optimize`` with its default chooser
and ``memory-removed`` cost, and ``paths.ssa_to_linear``.  It gives the
same path as opt_einsum 3.4.0 for the same inputs (the tests check it).

Adapted from opt_einsum 3.4.0 (https://github.com/dgasmith/opt_einsum),
``opt_einsum/paths.py`` and ``opt_einsum/contract.py``.
Copyright (c) 2014 Daniel Smith.  Released under the MIT licence:

    Permission is hereby granted, free of charge, to any person obtaining
    a copy of this software and associated documentation files (the
    "Software"), to deal in the Software without restriction, including
    without limitation the rights to use, copy, modify, merge, publish,
    distribute, sublicense, and/or sell copies of the Software, and to
    permit persons to whom the Software is furnished to do so, subject to
    the following conditions:

    The above copyright notice and this permission notice shall be
    included in all copies or substantial portions of the Software.

    THE SOFTWARE IS PROVIDED "AS IS", WITHOUT WARRANTY OF ANY KIND,
    EXPRESS OR IMPLIED, INCLUDING BUT NOT LIMITED TO THE WARRANTIES OF
    MERCHANTABILITY, FITNESS FOR A PARTICULAR PURPOSE AND
    NONINFRINGEMENT. IN NO EVENT SHALL THE AUTHORS OR COPYRIGHT HOLDERS BE
    LIABLE FOR ANY CLAIM, DAMAGES OR OTHER LIABILITY, WHETHER IN AN ACTION
    OF CONTRACT, TORT OR OTHERWISE, ARISING FROM, OUT OF OR IN CONNECTION
    WITH THE SOFTWARE OR THE USE OR OTHER DEALINGS IN THE SOFTWARE.
"""

import bisect
from collections import defaultdict
import heapq
import itertools

__all__ = ['greedy_path', 'ssa_greedy_optimize', 'ssa_to_linear']


def _size(indices, sizes) -> int:
    ret = 1
    for i in indices:
        ret *= sizes[i]
    return ret


def ssa_to_linear(ssa_path):
    """Static-single-assignment ids -> recycled linear ids."""
    n = sum(map(len, ssa_path)) - len(ssa_path) + 1
    ids = list(range(n))
    path = []
    ssa = n
    for scon in ssa_path:
        con = sorted([bisect.bisect_left(ids, s) for s in scon])
        for j in reversed(con):
            ids.pop(j)
        ids.append(ssa)
        path.append(con)
        ssa += 1
    return [tuple(x) for x in path]


def _get_candidate(output, sizes, remaining, footprints, dim_ref_counts, k1,
                   k2):
    either = k1 | k2
    two = k1 & k2
    one = either - two
    k12 = ((either & output) | (two & dim_ref_counts[3]) |
           (one & dim_ref_counts[2]))
    # 'memory-removed': size12 - size1 - size2
    cost = _size(k12, sizes) - footprints[k1] - footprints[k2]
    id1 = remaining[k1]
    id2 = remaining[k2]
    if id1 > id2:
        k1, id1, k2, id2 = k2, id2, k1, id1
    cost = cost, id2, id1  # break ties to ensure determinism
    return cost, k1, k2, k12


def _push_candidate(output, sizes, remaining, footprints, dim_ref_counts, k1,
                    k2s, queue) -> None:
    candidates = (_get_candidate(output, sizes, remaining, footprints,
                                 dim_ref_counts, k1, k2) for k2 in k2s)
    heapq.heappush(queue, min(candidates))


def _update_ref_counts(dim_to_keys, dim_ref_counts, dims) -> None:
    for dim in dims:
        count = len(dim_to_keys[dim])
        if count <= 1:
            dim_ref_counts[2].discard(dim)
            dim_ref_counts[3].discard(dim)
        elif count == 2:
            dim_ref_counts[2].add(dim)
            dim_ref_counts[3].discard(dim)
        else:
            dim_ref_counts[2].add(dim)
            dim_ref_counts[3].add(dim)


def ssa_greedy_optimize(inputs, output, sizes):
    """Hadamard products, then greedy memory-removed contractions, then
    greedy outer products; returns an SSA path."""
    if len(inputs) == 1:
        return [(0,)]

    # A dim common to all tensors cannot be contracted until the end.
    fs_inputs = [frozenset(x) for x in inputs]
    output = frozenset(output) | frozenset.intersection(*fs_inputs)

    # Deduplicate shapes by eagerly computing Hadamard products.
    remaining = {}  # key -> ssa_id
    ssa_ids = itertools.count(len(fs_inputs))
    ssa_path = []
    for ssa_id, key in enumerate(fs_inputs):
        if key in remaining:
            ssa_path.append((remaining[key], ssa_id))
            remaining[key] = next(ssa_ids)
        else:
            remaining[key] = ssa_id

    dim_to_keys = defaultdict(set)
    for key in remaining:
        for dim in key - output:
            dim_to_keys[dim].add(key)

    dim_ref_counts = {
        count: {dim for dim, keys in dim_to_keys.items()
                if len(keys) >= count} - output
        for count in [2, 3]
    }

    footprints = {key: _size(key, sizes) for key in remaining}

    queue = []
    for dim, dim_keys in dim_to_keys.items():
        dim_keys_list = sorted(dim_keys, key=remaining.__getitem__)
        for i, k1 in enumerate(dim_keys_list[:-1]):
            _push_candidate(output, sizes, remaining, footprints,
                            dim_ref_counts, k1, dim_keys_list[1 + i:],
                            queue)

    while queue:
        cost, k1, k2, k12 = heapq.heappop(queue)
        if k1 not in remaining or k2 not in remaining:
            continue  # candidate is obsolete

        ssa_id1 = remaining.pop(k1)
        ssa_id2 = remaining.pop(k2)
        for dim in k1 - output:
            dim_to_keys[dim].remove(k1)
        for dim in k2 - output:
            dim_to_keys[dim].remove(k2)
        ssa_path.append((ssa_id1, ssa_id2))
        if k12 in remaining:
            ssa_path.append((remaining[k12], next(ssa_ids)))
        else:
            for dim in k12 - output:
                dim_to_keys[dim].add(k12)
        remaining[k12] = next(ssa_ids)
        _update_ref_counts(dim_to_keys, dim_ref_counts, k1 | k2 - output)
        footprints[k12] = _size(k12, sizes)

        k1 = k12
        k2s = {k2 for dim in k1 for k2 in dim_to_keys[dim]}
        k2s.discard(k1)
        if k2s:
            _push_candidate(output, sizes, remaining, footprints,
                            dim_ref_counts, k1, list(k2s), queue)

    # Greedily compute pairwise outer products.
    final_queue = [(_size(key & output, sizes), ssa_id, key)
                   for key, ssa_id in remaining.items()]
    heapq.heapify(final_queue)
    _, ssa_id1, k1 = heapq.heappop(final_queue)
    while final_queue:
        _, ssa_id2, k2 = heapq.heappop(final_queue)
        ssa_path.append((min(ssa_id1, ssa_id2), max(ssa_id1, ssa_id2)))
        k12 = (k1 | k2) & output
        cost = _size(k12, sizes)
        ssa_id12 = next(ssa_ids)
        _, ssa_id1, k1 = heapq.heappushpop(final_queue, (cost, ssa_id12, k12))

    return ssa_path


def greedy_path(subscripts: str, size: int = 2):
    """``opt_einsum.contract_path(subscripts, *shapes, shapes=True,
    optimize='greedy')[0]`` for uniform dims ``size``.

    ``subscripts`` is an explicit einsum string (``'ab,bc->ac'``), one
    character per index.
    """
    lhs, rhs = subscripts.split('->')
    input_list = lhs.split(',')
    num_ops = len(input_list)
    if num_ops <= 2:
        # Nothing to be optimized (contract_path's own shortcut).
        return [tuple(range(num_ops))]
    input_sets = [frozenset(x) for x in input_list]
    sizes = {c: size for c in lhs.replace(',', '') + rhs}
    return ssa_to_linear(
        ssa_greedy_optimize(input_sets, frozenset(rhs), sizes))

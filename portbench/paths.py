"""Random initial contraction paths, the replicas' starting points.

Users of the optimizer start every replica from a random path: the
greedy path finder of opt_einsum over a shuffled tensor order, seeded per
replica.  This is a frozen copy of that builder (the greedy search is
opt_einsum 3.4.0's ``paths.ssa_greedy_optimize`` with its default chooser
and 'memory-removed' cost), so that no change to the program can move
the starting points.

A cell's starting paths are built once and kept as a data file,
``starts/<name>.json`` (the traffic mix names it under ``"starts"``), so
that a run loads them and spends none of its set-up on them.  Write one
with ``python3 -m portbench.paths <name> '<network entry>' <count>``;
the file holds the network entry, the seeds ``0 .. count - 1`` and one
path per seed.

Adapted from opt_einsum 3.4.0 (https://github.com/dgasmith/opt_einsum),
``opt_einsum/paths.py``.  Copyright (c) 2014 Daniel Smith.  Released under
the MIT licence:

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
from collections import Counter, defaultdict
import heapq
import itertools
import json
from random import Random
import sys

__all__ = ['random_path', 'ssa_greedy_optimize', 'load_starts',
           'write_starts']


def _size(indices, sizes) -> int:
    ret = 1
    for i in indices:
        ret *= sizes[i]
    return ret


def _ssa_to_linear(ssa_path):
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


def _connected(ts_inds) -> bool:
    """Whether every tensor shares an index path with the first."""
    owners = defaultdict(list)
    for t, xs in enumerate(ts_inds):
        for x in xs:
            owners[x].append(t)
    seen = {0}
    stack = [0]
    while stack:
        for x in ts_inds[stack.pop()]:
            for u in owners[x]:
                if u not in seen:
                    seen.add(u)
                    stack.append(u)
    return len(seen) == len(ts_inds)


def random_path(ts_inds, output_inds, dims, seed: int):
    """The random initial path of a connected network for ``seed``: a
    linear (einsum-style) path over all tensors.

    The tensors are shuffled with ``random.Random(seed)``, the greedy
    search runs on the shuffled list (open indices shared by more than one
    tensor are not kept open, so that only tensors sharing an index are
    paired), and its steps are mapped back to the tensors' own order.
    """
    ts_inds = [tuple(xs) for xs in ts_inds]
    n = len(ts_inds)
    if not _connected(ts_inds):
        raise ValueError('The network is not connected.')
    count = Counter(itertools.chain.from_iterable(ts_inds))
    for x in output_inds:
        count[x] += 1
    output = frozenset(x for x in output_inds if count[x] - 1 <= 1)

    order = list(range(n))
    Random(seed).shuffle(order)
    inputs = [frozenset(ts_inds[i]) for i in order]
    output = output & frozenset(itertools.chain.from_iterable(inputs))
    if n <= 2:
        local = [tuple(range(n))]
    else:
        local = _ssa_to_linear(ssa_greedy_optimize(inputs, output, dims))

    # Local linear steps -> contractions of tensor ids (new ids from n on).
    loc = list(order)
    steps = []
    for step, (px, py) in enumerate(local):
        px, py = sorted((px, py))
        ty = loc.pop(py)
        tx = loc.pop(px)
        loc.append(n + step)
        steps.append((tx, ty, n + step))

    # Back to a linear path over the tensors' own order.
    path = []
    loc = list(range(n))
    for x, y, z in steps:
        px, py = sorted(bisect.bisect_left(loc, t) for t in (x, y))
        loc.pop(py)
        loc.pop(px)
        loc.append(z)
        path.append((px, py))
    return path


def write_starts(path, network: dict, count: int) -> None:
    """Writes the starting paths of seeds ``0 .. count - 1`` on
    ``network`` (a configuration's ``network`` entry) to ``path``."""
    from portbench import networks
    ts_inds, output_inds, dims = networks.build(network)
    rows = [json.dumps([list(step) for step in
                        random_path(ts_inds, output_inds, dims, seed)],
                       separators=(',', ':')) for seed in range(count)]
    head = json.dumps({'network': network, 'seeds': list(range(count))})
    path.write_text(head[:-1] + ', "paths": [\n' + ',\n'.join(rows) +
                    '\n]}\n')


def load_starts(path, network: dict, count: int) -> list:
    """The first ``count`` starting paths of the file at ``path``, which
    must have been written for ``network``."""
    data = json.loads(path.read_text())
    if data['network'] != network:
        raise ValueError(f'{path.name} holds paths of {data["network"]}, '
                         f'not of {network}.')
    if len(data['paths']) < count:
        raise ValueError(f'{path.name} holds {len(data["paths"])} paths, '
                         f'not {count}.')
    return [[tuple(step) for step in p] for p in data['paths'][:count]]


if __name__ == '__main__':
    from portbench import spec
    name, network, count = sys.argv[1], json.loads(sys.argv[2]), \
        int(sys.argv[3])
    write_starts(spec.starts_file(name), network, count)

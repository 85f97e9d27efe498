"""The plain reference: contraction trees and their costs, worked out again
from the network alone.

Python integers and numpy only; it imports nothing of the program.  Given
the network the harness generated and a tree (the children and parent of
every node, leaves ``0..L-1`` in the network's tensor order), it checks
that the tree is one binary contraction tree over all tensors, derives the
index set of every node from the leaves (an index leaves a node's set once
every tensor that carries it lies in the node's subtree, unless it is
open), and charges each contraction the product of the dimensions of the
union of its children's sets, and of the sliced indices under a width cap
(the cost of one slice times the number of slices).  Totals are exact
integers.  Under a cap every node's set, less the sliced indices, must
fit the cap.

Index sets are Python integers used as bitsets: bit ``j`` is the index
``order[j]``, the order the harness hands the program, so the program's
slice words read as ``sum(word[w] << 32 * w)``.
"""

import math

import numpy as np
import torch

__all__ = ['Reference', 'TreeReport', 'log2_total_lowp', 'lanes_to_mask',
           'path_shape', 'tree_shape']


def lanes_to_mask(lanes) -> int:
    """``uint32 [W]`` words (any integer dtype, read as unsigned 32-bit)
    -> one integer bitset, word ``w`` at bits ``32 w .. 32 w + 31``."""
    mask = 0
    for i, word in enumerate(np.asarray(lanes).astype(np.int64).ravel()):
        mask |= (int(word) & 0xFFFFFFFF) << (32 * i)
    return mask


class TreeReport:
    """What the reference finds in one tree: ``reason`` (None for a valid
    tree), ``log2_costs`` (each contraction's log2 cost, post order),
    ``total`` (the exact total, an integer) and ``over_cap`` (nodes whose
    sliced width exceeds the cap)."""

    def __init__(self, reason=None, log2_costs=(), total=0, over_cap=0):
        self.reason = reason
        self.log2_costs = list(log2_costs)
        self.total = total
        self.over_cap = over_cap

    @property
    def valid(self) -> bool:
        return self.reason is None

    @property
    def log2_total(self) -> float:
        return math.log2(self.total) if self.total > 0 else -math.inf


class Reference:
    """The reference for one network.

    Args:
        ts_inds: one index tuple per tensor.
        output_inds: the open indices.
        dims: the dimension of every index.
        order: every index once; bit ``j`` of a set is ``order[j]``.
    """

    def __init__(self, ts_inds, output_inds, dims, order):
        self.order = list(order)
        pos = {x: j for j, x in enumerate(self.order)}
        if len(pos) != len(self.order):
            raise ValueError('order lists an index twice.')
        self.n_bits = len(self.order)
        self.n_leaves = len(ts_inds)
        self.leaf_sets = []
        count = {}
        for xs in ts_inds:
            s = 0
            for x in set(xs):
                s |= 1 << pos[x]
                count[x] = count.get(x, 0) + 1
            self.leaf_sets.append(s)
        self.out_mask = sum(1 << pos[x] for x in output_inds)
        # Indices on exactly two tensors leave a node's set when both of
        # its children carry them; those on three or more are counted.
        self.two_mask = sum(1 << pos[x] for x, c in count.items() if c == 2)
        self.hyper = [x for x in self.order if count.get(x, 0) >= 3]
        self.hyper_total = np.array([count[x] for x in self.hyper],
                                    dtype=np.int64)
        self.hyper_bits = [pos[x] for x in self.hyper]
        self.dims = [int(dims[x]) for x in self.order]
        log2d = [d.bit_length() - 1 for d in self.dims]
        self.pow2 = all(d == 1 << e for d, e in zip(self.dims, log2d))
        # Indices grouped by log2 dimension: a set's log2 size is the sum
        # over groups of the group's exponent times its popcount.
        self.classes = {}
        for j, e in enumerate(log2d):
            self.classes[e] = self.classes.get(e, 0) | (1 << j)

    # -- sizes ------------------------------------------------------------

    def log2_size(self, s: int) -> float:
        """log2 of the product of the dimensions of set ``s``."""
        if self.pow2:
            return float(sum(e * (s & m).bit_count()
                             for e, m in self.classes.items()))
        return math.log2(self.size(s))

    def size(self, s: int) -> int:
        """The product of the dimensions of set ``s``, exactly."""
        if self.pow2:
            return 1 << sum(e * (s & m).bit_count()
                            for e, m in self.classes.items())
        out = 1
        j = 0
        while s:
            if s & 1:
                out *= self.dims[j]
            s >>= 1
            j += 1
        return out

    # -- contraction ------------------------------------------------------

    def _leaf_counts(self, leaf: int):
        s = self.leaf_sets[leaf]
        return np.array([(s >> b) & 1 for b in self.hyper_bits],
                        dtype=np.int64)

    def _merge(self, a, b):
        """The set of a contraction of ``a = (set, hyper counts)`` and
        ``b``; returns ``(set, counts)`` and the union of the children."""
        (sa, ca), (sb, cb) = a, b
        union = sa | sb
        gone = sa & sb & self.two_mask
        counts = ca + cb
        for k, bit in enumerate(self.hyper_bits):
            if counts[k] == self.hyper_total[k]:
                gone |= 1 << bit
        return (union & ~(gone & ~self.out_mask), counts), union

    def _charge(self, union: int, slices: int):
        """One contraction's log2 cost and exact cost."""
        s = union | slices
        return self.log2_size(s), self.size(s)

    def path_report(self, path, slices: int = 0) -> TreeReport:
        """The costs of a linear (einsum-style) path over all tensors."""
        live = [(s, self._leaf_counts(i)) for i, s in
                enumerate(self.leaf_sets)]
        logs, total = [], 0
        for px, py in path:
            px, py = sorted((int(px), int(py)))
            b = live.pop(py)
            a = live.pop(px)
            node, union = self._merge(a, b)
            lg, c = self._charge(union, slices)
            logs.append(lg)
            total += c
            live.append(node)
        if len(live) != 1:
            return TreeReport('the path leaves more than one tensor')
        return TreeReport(None, logs, total)

    def tree_report(self, c0, c1, par, slices: int = 0,
                    max_width=None) -> TreeReport:
        """Checks a tree given as ``c0, c1, par`` (one entry per node, -1
        for none) and charges it; with ``max_width`` also counts the nodes
        whose set, less ``slices``, is wider than the cap."""
        c0 = [int(x) for x in c0]
        c1 = [int(x) for x in c1]
        par = [int(x) for x in par]
        n, n_leaves = len(c0), self.n_leaves
        if n != 2 * n_leaves - 1 or len(c1) != n or len(par) != n:
            return TreeReport(f'{n} nodes for {n_leaves} tensors')
        if slices >> self.n_bits:
            return TreeReport('slices name an index the network lacks')
        for i in range(n):
            if i < n_leaves:
                if c0[i] != -1 or c1[i] != -1:
                    return TreeReport(f'leaf {i} has children')
            elif not (0 <= c0[i] < n and 0 <= c1[i] < n) or c0[i] == c1[i]:
                return TreeReport(f'node {i} has children {c0[i]}, {c1[i]}')
            elif par[c0[i]] != i or par[c1[i]] != i:
                return TreeReport(f'node {i} is not its children\'s parent')
        roots = [i for i in range(n) if par[i] == -1]
        if len(roots) != 1 or (n > 1 and roots[0] < n_leaves):
            return TreeReport(f'roots {roots[:4]}')

        # Post order from the root; every node once.
        seen = [False] * n
        post = []
        stack = [(roots[0], False)]
        while stack:
            i, done = stack.pop()
            if done:
                post.append(i)
                continue
            if seen[i]:
                return TreeReport(f'node {i} is reached twice')
            seen[i] = True
            stack.append((i, True))
            if i >= n_leaves:
                stack.append((c1[i], False))
                stack.append((c0[i], False))
        if len(post) != n:
            return TreeReport(f'{n - len(post)} nodes are not under the root')

        node = [None] * n
        logs, total = [], 0
        for i in post:
            if i < n_leaves:
                node[i] = (self.leaf_sets[i], self._leaf_counts(i))
                continue
            node[i], union = self._merge(node[c0[i]], node[c1[i]])
            lg, c = self._charge(union, slices)
            logs.append(lg)
            total += c
        over = 0
        if max_width is not None:
            cap = float(max_width)
            for i in range(n):
                if self.log2_size(node[i][0] & ~slices) > cap:
                    over += 1
        return TreeReport(None, logs, total, over)


def path_shape(path, n_leaves: int) -> frozenset:
    """The shape of the tree a linear path builds: the set of the leaf
    sets (integer bitsets over the tensors) of its contractions."""
    live = [1 << i for i in range(n_leaves)]
    out = []
    for px, py in path:
        px, py = sorted((int(px), int(py)))
        b = live.pop(py)
        a = live.pop(px)
        live.append(a | b)
        out.append(a | b)
    return frozenset(out)


def tree_shape(c0, c1, par, n_leaves: int):
    """:func:`path_shape` of a tree given as ``c0, c1, par``, or None when
    it is not a tree over ``n_leaves`` leaves with a root."""
    c0 = [int(x) for x in c0]
    c1 = [int(x) for x in c1]
    roots = [i for i, p in enumerate(par) if int(p) == -1]
    if len(roots) != 1 or len(c0) != 2 * n_leaves - 1:
        return None
    n = len(c0)
    leaves = [0] * n
    out = []
    stack = [(roots[0], False)]
    while stack:
        i, done = stack.pop()
        if not 0 <= i < n or len(out) + len(stack) > 2 * n:
            return None
        if i < n_leaves:
            leaves[i] = 1 << i
        elif done:
            leaves[i] = leaves[c0[i]] | leaves[c1[i]]
            out.append(leaves[i])
        else:
            stack += [(i, True), (c1[i], False), (c0[i], False)]
    return frozenset(out)


def log2_total_lowp(log2_costs, dtype=torch.bfloat16) -> float:
    """The log2 total of the contractions' log2 costs computed in
    ``dtype`` throughout, as the program computes it in its own float
    type: ``m + log2(sum(exp2(c - m)))`` with ``m`` the largest cost, the
    sum a pairwise tree, every operation rounded to ``dtype``.  This is
    the lower-precision control."""
    x = torch.tensor(list(log2_costs), dtype=torch.float64).to(dtype)
    m = x.max()
    t = torch.exp2(x - m)
    while t.numel() > 1:
        if t.numel() % 2:
            t = torch.cat([t, torch.zeros(1, dtype=dtype)])
        t = t[0::2] + t[1::2]
    return float(m + torch.log2(t[0]))

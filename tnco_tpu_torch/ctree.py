"""Array-backed contraction tree (host side; the port's own copy of
``tnco_tpu/ctree.py``: validation takes the port's native validator
(``tnco_tpu_torch.native``) when it is available and the numpy
implementation below, its plain version, otherwise; exact costs are Python
bigints).

The canonical tree representation is a pair of flat arrays (uploaded to
the device engines as int32 bit patterns):

- ``nodes``: ``int32[N, 3]`` rows ``(child0, child1, parent)`` with ``-1`` as
  null.  Leaves occupy positions ``0..L-1``, the root is the last node, and
  ``N = 2L - 1`` (same layout contract as the reference flat tree,
  include/tnco/tree.hpp:34-204 and node.hpp:32-107).
- ``inds``: ``uint32[N, W]`` bitset lanes, one row per node, bit ``j`` =
  index ``inds_order[j]`` (replacing boost::dynamic_bitset,
  include/tnco/bitset.hpp).

Construction from an einsum path reproduces the hyper-index bookkeeping of
the reference Python wrapper (tnco/ctree.py:69-251): intermediate index sets
are ``(x ^ y) | surviving-hyper | output`` with a per-index hyper counter.
"""

from collections.abc import Callable, Iterable
from types import MappingProxyType
from typing import Any

import numpy as np

from tnco_tpu_torch import native
from tnco_tpu_torch.bitset import Bitset, n_lanes

__all__ = ['ContractionTree', 'Node', 'traverse', 'traverse_tree',
           'get_contraction']

NULL = -1


class Node:
    """Binary-tree node: two children and a parent (``None`` = null).

    API-parity stand-in for the reference core node
    (include/tnco/node.hpp:32-107).
    """

    __slots__ = ('children', 'parent')

    def __init__(self, children=(None, None), parent=None) -> None:
        c0, c1 = children
        c0 = None if c0 is None or c0 < 0 else int(c0)
        c1 = None if c1 is None or c1 < 0 else int(c1)
        parent = None if parent is None or parent < 0 else int(parent)
        if (c0 is None) ^ (c1 is None):
            raise ValueError("Both children must be provided or absent.")
        if c0 is not None and c0 == c1:
            raise ValueError("children must be different.")
        if (c0 is not None and parent is not None and
                parent in (c0, c1)):
            raise ValueError("parent must be different from children.")
        self.children = (c0, c1)
        self.parent = parent

    def is_leaf(self) -> bool:
        return self.children[0] is None

    def is_root(self) -> bool:
        return self.parent is None

    def __eq__(self, other: Any) -> bool:
        return (isinstance(other, Node) and self.children == other.children
                and self.parent == other.parent)

    def __hash__(self) -> int:
        return hash((self.children, self.parent))

    def __repr__(self) -> str:
        return f'Node(children={self.children}, parent={self.parent})'

    def __reduce__(self):
        return type(self), (self.children, self.parent)


def _unique_everseen(iterable: Iterable[Any]) -> list[Any]:
    return list(dict.fromkeys(iterable))


def _flatten(iterables: Iterable[Iterable[Any]]):
    for xs in iterables:
        yield from xs


def traverse(tree: 'ContractionTree | np.ndarray',
             callback: Callable[[int], None]) -> None:
    """Iterative post-order traversal (child0 first, root last).

    Mirrors the traversal contract of the reference core
    (include/tnco/utils.hpp:34-51) so that path round-trips agree.
    """
    nodes = tree.nodes_array if isinstance(tree, ContractionTree) else \
        np.asarray(tree)
    n = len(nodes)
    visited = np.zeros(n, dtype=bool)
    stack = [n - 1]
    while stack:
        pos = stack[-1]
        if visited[pos] or nodes[pos, 0] == NULL:
            stack.pop()
            callback(int(pos))
        else:
            visited[pos] = True
            stack.append(int(nodes[pos, 1]))
            stack.append(int(nodes[pos, 0]))


def get_contraction(tree: 'ContractionTree') -> list[tuple[int, int, int]]:
    """Post-order list of contractions ``(child0, child1, out)``.

    Reference: include/tnco/utils.hpp:53-71.
    """
    nodes = tree.nodes_array if isinstance(tree, ContractionTree) else \
        np.asarray(tree)
    out = []

    def cb(pos: int) -> None:
        if nodes[pos, 0] != NULL:
            out.append((int(nodes[pos, 0]), int(nodes[pos, 1]), pos))

    traverse(nodes, cb)
    return out


def _get_hyper_count(ts_inds, output_inds=None):
    """#occurrences - 1 per index (+1 if output).

    Reference: tnco/utils/tn.py:572-595.  Local copy to avoid an import cycle
    with :mod:`tnco_tpu_torch.utils.tn`.
    """
    count: dict[Any, int] = {}
    for xs in ts_inds:
        for x in xs:
            count[x] = count.get(x, 0) + 1
    count = {x: c - 1 for x, c in count.items()}
    if output_inds is not None:
        for x in output_inds:
            count[x] = count.get(x, 0) + 1
    return count


class ContractionTree:
    """Contraction tree over labeled indices, stored as flat arrays.

    Args:
        path: Contraction path in linear (einsum) format, or a list of
            ``Node`` (with ``_cache`` provided, for pickling).
        ts_inds: List of index labels for each input tensor.
        dims: Either an int (uniform dimension) or a map label -> dim.
        output_inds: Output indices; required when ``ts_inds`` has
            hyper-indices.
        check_shared_inds: Require every contraction to share an index.

    Examples:
        >>> from tnco_tpu_torch.ctree import ContractionTree
        >>> ctree = ContractionTree([(0, 1)], [['i', 'j'], ['j', 'k']],
        ...                         {'i': 2, 'j': 2, 'k': 2})
        >>> ctree.path()
        [(0, 1)]
        >>> ctree.max_width()
        2.0
    """

    def __init__(self,
                 path,
                 ts_inds,
                 dims,
                 *,
                 output_inds=None,
                 check_shared_inds: bool = False,
                 inds_order=None,
                 verbose: int = 0,
                 **kwargs) -> None:
        """``inds_order``: optional explicit label -> bit-position order.

        Replicas batched on device must share the bit layout; the replica
        runner passes one canonical order per connected component.
        """
        _cache = kwargs.pop('_cache', None)
        if kwargs:
            raise TypeError("Got unexpected keyword arguments.")

        ts_inds = list(ts_inds)
        path = list(path)

        if path and all(isinstance(x, Node) for x in path):
            # Rebuild from nodes (pickle round-trip).
            if output_inds is not None:
                raise ValueError(
                    "'output_inds' cannot be provided if a contraction "
                    "tree is used instead of a path.")
            if _cache is None:
                raise RuntimeError("'_cache' must be provided.")
            self._n_tensors = int(_cache[0])
            self._tensors_pos = tuple(_cache[1])
            self._inds_order = tuple(_cache[2])
            if frozenset(self._inds_order) != frozenset(_flatten(ts_inds)):
                raise ValueError("'_inds_order' is not valid.")
            node_rows = [[
                NULL if node.children[0] is None else node.children[0],
                NULL if node.children[1] is None else node.children[1],
                NULL if node.parent is None else node.parent,
            ] for node in path]
            node_ts_inds = list(map(tuple, ts_inds))
        else:
            (node_rows, node_ts_inds) = self._build_from_path(
                path, ts_inds, output_inds, check_shared_inds)
            dims = self._restrict_dims(dims, node_ts_inds)
            derived = tuple(_unique_everseen(_flatten(node_ts_inds)))
            if inds_order is None:
                self._inds_order = derived
            else:
                inds_order = tuple(inds_order)
                if frozenset(inds_order) != frozenset(derived):
                    raise ValueError("'inds_order' is not consistent with "
                                     "the tree's indices.")
                self._inds_order = inds_order

        # Label -> bit position
        inds_map = {x: i for i, x in enumerate(self._inds_order)}
        n_inds = len(self._inds_order)

        # dims as per-index vector (int labels kept exact)
        try:
            d = int(dims)
            if d != dims:
                raise ValueError("'dims' is not valid.")
            dims_vec = np.full(n_inds, d, dtype=np.int64)
        except (TypeError, ValueError) as e:
            if not isinstance(dims, dict) and not hasattr(dims, 'get'):
                raise ValueError("'dims' is not valid.") from e
            dims_vec = np.array([dims[x] for x in self._inds_order],
                                dtype=np.int64)

        # Pack arrays (vectorized: one scatter-or over all set bits)
        n_nodes = len(node_rows)
        w = n_lanes(n_inds)
        nodes_arr = np.asarray(node_rows, dtype=np.int32).reshape(n_nodes, 3)
        inds_arr = np.zeros((n_nodes, w), dtype=np.uint32)
        rows = np.fromiter(
            (t for t, xs in enumerate(node_ts_inds) for _ in xs),
            dtype=np.int64)
        positions = np.fromiter(
            (inds_map[x] for xs in node_ts_inds for x in xs),
            dtype=np.int64)
        np.bitwise_or.at(
            inds_arr, (rows, positions >> 5),
            (np.uint32(1) << (positions & 31).astype(np.uint32)))

        self._nodes = nodes_arr
        self._inds = inds_arr
        self._dims = dims_vec
        self._n_inds = n_inds

        valid, msg = self.is_valid(check_shared_inds=check_shared_inds,
                                   return_message=True)
        if not valid:
            raise ValueError(msg)

    # -- Construction helpers -------------------------------------------------

    def _build_from_path(self, path, ts_inds, output_inds,
                         check_shared_inds):
        """Simulate the einsum path and derive intermediate index sets.

        Reference semantics: tnco/ctree.py:107-226 (hyper-count rules).
        """
        n_tensors = len(ts_inds)

        # Linear path -> absolute contraction triples
        contraction = []
        pos_ = list(range(n_tensors))
        for i_, xs_ in enumerate(path):
            x_, y_ = sorted(xs_)
            py_ = pos_.pop(y_)
            px_ = pos_.pop(x_)
            pos_.append(i_ + n_tensors)
            contraction.append((px_, py_, pos_[-1]))
        if not contraction:
            raise ValueError("'path' cannot be empty.")

        # Original tensor positions actually touched by the path
        self._n_tensors = n_tensors
        self._tensors_pos = tuple(
            sorted(
                x for x in _unique_everseen(_flatten(contraction))
                if x < n_tensors))

        all_inds = _unique_everseen(
            _flatten(ts_inds[x] for x in self._tensors_pos))

        hyper_count = _get_hyper_count(ts_inds[x] for x in self._tensors_pos)

        if output_inds is None:
            if any(c > 1 for c in hyper_count.values()):
                raise ValueError("'output_inds' must be provided if "
                                 "'ts_inds' has hyper-indices.")
            output_inds = frozenset(x for x, c in hyper_count.items()
                                    if c == 0)
        else:
            output_inds = frozenset(output_inds)

        # Ignore output inds not present in this (sub)network
        output_inds = output_inds.intersection(all_inds)
        for x_ in output_inds:
            hyper_count[x_] = hyper_count.get(x_, 0) + 1

        # Derive intermediates
        ts_inds = list(ts_inds)
        ts_inds.extend(
            [None] * (max(_flatten(contraction)) - n_tensors + 1))
        for tx_, ty_, tz_ in contraction:
            ix_ = frozenset(ts_inds[tx_])
            iy_ = frozenset(ts_inds[ty_])
            shared_ = ix_ & iy_
            if check_shared_inds and not shared_:
                raise ValueError("'check_shared_inds' failed.")
            iz_ = ix_ ^ iy_
            for is_ in shared_:
                assert hyper_count[is_] > 0
                hyper_count[is_] -= 1
                if hyper_count[is_] > 0:
                    iz_ |= {is_}
            # Deterministic ordering of the new index tuple
            ts_inds[tz_] = tuple(
                _unique_everseen(x for x in (*ts_inds[tx_], *ts_inds[ty_])
                                 if x in iz_))

        # Compress absolute positions -> 0..N-1 (leaves first, root last)
        pos_ = sorted(_unique_everseen(_flatten(contraction)))
        assert (len(pos_) >= len(self._tensors_pos) and
                tuple(pos_[:len(self._tensors_pos)]) == self._tensors_pos)
        tree_map_ = {p: i for i, p in enumerate(pos_)}
        tree_ = [tuple(tree_map_[p] for p in xs) for xs in contraction]

        node_rows = [[NULL, NULL, NULL]
                     for _ in range(max(_flatten(tree_)) + 1)]
        for x_, y_, z_ in tree_:
            node_rows[x_][2] = z_
            node_rows[y_][2] = z_
            node_rows[z_][0] = x_
            node_rows[z_][1] = y_

        node_ts_inds = [tuple(ts_inds[p]) for p in pos_]
        return node_rows, node_ts_inds

    @staticmethod
    def _restrict_dims(dims, node_ts_inds):
        try:
            return {
                x: dims[x]
                for x in _unique_everseen(_flatten(node_ts_inds))
            }
        except TypeError as e:
            if int(dims) != dims:
                raise ValueError("'dims' is not valid.") from e
            return int(dims)

    # -- Array accessors (device-facing) --------------------------------------

    @property
    def nodes_array(self) -> np.ndarray:
        """``int32[N, 3]`` rows ``(child0, child1, parent)``."""
        return self._nodes

    @property
    def inds_array(self) -> np.ndarray:
        """``uint32[N, W]`` bitset lanes."""
        return self._inds

    @property
    def dims_array(self) -> np.ndarray:
        """``int64[n_inds]`` dimension per bit position."""
        return self._dims

    @property
    def log2_dims_array(self) -> np.ndarray:
        """``float64[n_inds]`` log2 of each dimension."""
        return np.log2(self._dims.astype(np.float64))

    # -- Label-space API (reference parity) -----------------------------------

    def __len__(self) -> int:
        return len(self._nodes)

    @property
    def n_leaves(self) -> int:
        return (len(self) + 1) // 2

    @property
    def n_inds(self) -> int:
        return self._n_inds

    @property
    def nodes(self) -> list[Node]:
        return [
            Node((None if c0 == NULL else int(c0),
                  None if c1 == NULL else int(c1)),
                 None if p == NULL else int(p))
            for c0, c1, p in self._nodes
        ]

    @property
    def inds(self):
        """Label-space per-node index sets (ref tnco/ctree.py:300-330)."""
        order = self._inds_order
        inds_arr = self._inds

        class IndsProxy:

            def __getitem__(self, key):

                def get(row):
                    b = Bitset.from_lanes(row, len(order))
                    return frozenset(order[p] for p in b.positions())

                if isinstance(key, int):
                    return get(inds_arr[key])
                return tuple(get(row) for row in inds_arr[key])

            def __len__(self) -> int:
                return len(inds_arr)

            def __iter__(self):
                # Every row at once: one bit matrix instead of a Bitset
                # per row (the same label sets).
                bits = np.unpackbits(
                    np.ascontiguousarray(inds_arr, dtype=np.uint32).view(
                        np.uint8), axis=1, bitorder='little')[:, :len(order)]
                return (frozenset(order[p] for p in np.flatnonzero(row))
                        for row in bits)

        return IndsProxy()

    def bitset(self, pos: int) -> Bitset:
        """Bitset of node ``pos`` in bit-position space."""
        return Bitset.from_lanes(self._inds[pos], self._n_inds)

    @property
    def dims(self):
        return MappingProxyType({
            x: int(d) for x, d in zip(self._inds_order, self._dims)
        })

    def all_inds(self) -> frozenset:
        return frozenset(self._inds_order)

    def output_inds(self) -> frozenset:
        return self.inds[-1]

    @property
    def inds_order(self) -> tuple:
        return self._inds_order

    # -- Validation -----------------------------------------------------------

    def is_valid(self,
                 check_shared_inds: bool = False,
                 return_message: bool = False):
        """Full structural + contraction validity.

        Ports tree.hpp:57-139 (tree structure) and ctree.hpp:101-152
        (per-contraction index rules), vectorized with numpy.
        """
        ok = self._is_valid_impl(check_shared_inds)
        return ok if return_message else ok[0]

    def _is_valid_impl(self, check_shared_inds):
        # The native validator (native/core.cpp) when it is available, as
        # in the JAX package; it gives the same (ok, message) as the numpy
        # code below, which is its plain version (_is_valid_numpy).
        res = native.validate(self._nodes, self._inds, check_shared_inds)
        if res is not None:
            return res
        return self._is_valid_numpy(check_shared_inds)

    def _is_valid_numpy(self, check_shared_inds):
        nodes = self._nodes
        n = len(nodes)
        c0, c1, par = nodes[:, 0], nodes[:, 1], nodes[:, 2]

        in_range = lambda x: (x == NULL) | ((x >= 0) & (x < n))
        if not (in_range(c0).all() and in_range(c1).all() and
                in_range(par).all()):
            return False, "Nodes are not valid"
        # Both children same nullity; children distinct; parent != children
        if ((c0 == NULL) != (c1 == NULL)).any():
            return False, "Nodes are not valid"
        internal = c0 != NULL
        if (internal & (c0 == c1)).any():
            return False, "Nodes are not valid"
        if (internal & (par != NULL) &
                ((par == c0) | (par == c1))).any():
            return False, "Nodes are not valid"
        if par[-1] != NULL:
            return False, "Last node should be root."
        if (par == NULL).sum() != 1:
            return False, "There should be only one root."
        n_leaves = int((~internal).sum())
        if not (~internal[:n_leaves]).all():
            return False, "All leaves should be first."
        if n != 2 * n_leaves - 1:
            return False, ("Number of nodes is not consistent with the "
                           "number of leaves.")
        # child_claims[x]: how many nodes list x as a child (1 unless root);
        # parent_claims[p]: how many nodes list p as parent (2 if internal).
        child_claims = np.zeros(n, dtype=np.int64)
        parent_claims = np.zeros(n, dtype=np.int64)
        np.add.at(child_claims, c0[internal], 1)
        np.add.at(child_claims, c1[internal], 1)
        np.add.at(parent_claims, par[par != NULL], 1)
        if not (parent_claims == np.where(internal, 2, 0)).all():
            return False, "Tree is not valid."
        if not (child_claims == np.where(par == NULL, 0, 1)).all():
            return False, "Tree is not valid."

        # Contraction validity per internal node
        inds = self._inds
        if len(inds) != n:
            return False, "Wrong number of indices."
        xs0 = inds[c0[internal]]
        xs1 = inds[c1[internal]]
        xs = inds[internal]
        if check_shared_inds and not (xs0 & xs1).any(axis=1).all():
            return False, "Contraction is not valid."
        sym = xs0 ^ xs1
        if (sym & ~xs).any():
            return False, "Contraction is not valid."
        if (xs & ~(xs0 | xs1)).any():
            return False, "Contraction is not valid."
        return True, ""

    # -- Tree move ------------------------------------------------------------

    def swap_with_nn(self, pos_d: int) -> None:
        """Swaps node ``pos_d`` with its uncle (the single tree move).

        In-place rewiring only — index sets are the optimizer's job.
        Reference: include/tnco/tree.hpp:141-192 (no-op on root/top nodes).
        """
        nodes = self._nodes
        if pos_d >= len(nodes):
            return
        pos_b = nodes[pos_d, 2]
        if pos_b == NULL:
            return
        pos_a = nodes[pos_b, 2]
        if pos_a == NULL:
            return
        pos_c = (nodes[pos_a, 1]
                 if nodes[pos_a, 0] == pos_b else nodes[pos_a, 0])
        # A's child C -> D; B's child D -> C
        slot_a = 0 if nodes[pos_a, 0] == pos_c else 1
        slot_b = 0 if nodes[pos_b, 0] == pos_d else 1
        nodes[pos_a, slot_a] = pos_d
        nodes[pos_b, slot_b] = pos_c
        nodes[pos_c, 2] = pos_b
        nodes[pos_d, 2] = pos_a

    # -- Path round-trip ------------------------------------------------------

    def path(self) -> list[tuple[int, int]]:
        """Contraction path in linear (einsum) format.

        Reference: tnco/ctree.py:350-388.
        """
        contraction = get_contraction(self)
        shift = self._n_tensors - self.n_leaves

        def rescale(pos):
            return (self._tensors_pos[pos]
                    if pos < len(self._tensors_pos) else pos + shift)

        contraction = [tuple(map(rescale, xs)) for xs in contraction]
        all_pos = list(range(self._n_tensors))
        path = []
        for *xs_, z_ in contraction:
            pos_ = tuple(all_pos.index(x) for x in xs_)
            path.append(pos_)
            if pos_[0] > pos_[1]:
                pos_ = pos_[1], pos_[0]
            all_pos.pop(pos_[1])
            all_pos.pop(pos_[0])
            all_pos.append(z_)
        return path

    def max_width(self) -> float:
        """Max over nodes of sum(log2 dims of its indices)."""
        log2d = self.log2_dims_array.astype(np.float64)
        bits = _expand_bits(self._inds, self._n_inds)
        return float((bits @ log2d).max())

    # -- Exact costs (host, bigint) -------------------------------------------

    def contraction_log2_costs(self) -> np.ndarray:
        """``float64[N]`` log2 contraction cost per node (0-width for leaves).

        Simple cost model: cost = prod(dims over in1 | in2)
        (include/tnco/optimize/infinite_memory/cost_model/simple.hpp:65-83).
        Leaves cost 0 (represented as -inf log2).
        """
        nodes, inds = self._nodes, self._inds
        internal = nodes[:, 0] != NULL
        out = np.full(len(nodes), -np.inf)
        union = inds[nodes[internal, 0]] | inds[nodes[internal, 1]]
        bits = _expand_bits(union, self._n_inds)
        out[internal] = bits @ self.log2_dims_array
        return out

    def total_cost_exact(self) -> int:
        """Exact total contraction cost as a Python bigint.

        Replaces the reference's 1024-bit floats
        (include/tnco/fixed_float.hpp) with exact integer arithmetic.
        """
        nodes = self._nodes
        dims = [int(d) for d in self._dims]
        total = 0
        for pos in range(len(nodes)):
            if nodes[pos, 0] == NULL:
                continue
            union = self.bitset(int(nodes[pos, 0])) | self.bitset(
                int(nodes[pos, 1]))
            c = 1
            for p in union.positions():
                c *= dims[p]
            total += c
        return total

    # -- Equality / pickle ----------------------------------------------------

    def __eq__(self, other: Any) -> bool:
        return (isinstance(other, ContractionTree) and
                np.array_equal(self._nodes, other._nodes) and
                np.array_equal(self._inds, other._inds) and
                np.array_equal(self._dims, other._dims) and
                self._inds_order == other._inds_order)

    def __hash__(self) -> int:
        return hash((self._nodes.tobytes(), self._inds.tobytes(),
                     self._dims.tobytes(), self._inds_order))

    def __repr__(self) -> str:
        return (f'ContractionTree(n_nodes={len(self)}, '
                f'n_inds={self.n_inds})')

    @staticmethod
    def __build__(*args) -> 'ContractionTree':
        nodes, ts_inds, dims, _cache = args
        return ContractionTree(nodes, ts_inds, dims, _cache=_cache)

    def __reduce__(self):
        ts_inds = [tuple(sorted(xs, key=self._inds_order.index))
                   for xs in self.inds]
        return self.__build__, (self.nodes, ts_inds, dict(self.dims),
                                (self._n_tensors, self._tensors_pos,
                                 self._inds_order))

    # -- Functional mutation (host-side) --------------------------------------

    def replace_arrays(self, nodes: np.ndarray,
                       inds: np.ndarray) -> 'ContractionTree':
        """New tree with the same labels/dims but different arrays."""
        new = object.__new__(ContractionTree)
        new._nodes = np.asarray(nodes, dtype=np.int32)
        new._inds = np.asarray(inds, dtype=np.uint32)
        new._dims = self._dims
        new._n_inds = self._n_inds
        new._inds_order = self._inds_order
        new._n_tensors = self._n_tensors
        new._tensors_pos = self._tensors_pos
        return new


def _expand_bits(lanes: np.ndarray, n_bits: int) -> np.ndarray:
    """``uint32[..., W]`` lanes -> ``float64[..., n_bits]`` 0/1 matrix."""
    lanes = np.asarray(lanes, dtype=np.uint32)
    shifts = np.arange(32, dtype=np.uint32)
    bits = (lanes[..., :, None] >> shifts) & 1  # [..., W, 32]
    bits = bits.reshape(*lanes.shape[:-1], lanes.shape[-1] * 32)
    return bits[..., :n_bits].astype(np.float64)


def traverse_tree(ctree: ContractionTree,
                  callback: Callable[[int], None],
                  *,
                  verbose: int = 0) -> None:
    """Traverses ``ctree`` post-order calling ``callback(pos)`` per node.

    Reference: tnco/ctree.py:407-434 (progress bar dropped; pure traversal).
    """
    del verbose
    traverse(ctree, callback)

"""Label-space cost models (infinite memory).

Reference: tnco/optimize/infinite_memory/cost_model.py:28-221 and
include/tnco/optimize/infinite_memory/cost_model/simple*.hpp.

``SimpleCostModel``: cost of a contraction = product of dims over
``in1 | in2`` (every index counted once).  With ``sparse_inds``, the sparse
part of the product is capped at ``n_projs``.  Host evaluation is exact
(Python bigints/floats); the device form is the log2 width of the union
(see ``tnco_tpu_torch.ops.costs.ccost_log2``).
"""

import functools as fts
import math
import operator as op
from typing import Any

import numpy as np

from tnco_tpu_torch.bitset import Bitset, n_lanes

__all__ = ['SimpleCostModel']


class SimpleCostModel:
    """Simple contraction cost model over labeled index sets.

    Args:
        cost_type: Numeric tag kept for API parity ('float32', 'float64',
            'float128', 'float1024').  Device kernels run in log2-domain
            float32 with exact host audits, so every tag is accepted.
        sparse_inds: Labels to treat as sparse.
        n_projs: Total number of projections among sparse indices; must be
            provided (positive) iff ``sparse_inds`` is non-empty.

    Examples:
        >>> from tnco_tpu_torch.optimize.infinite_memory import SimpleCostModel
        >>> cm = SimpleCostModel()
        >>> cm.contraction_cost({'i', 'j'}, {'j', 'k'}, {'i', 'k'},
        ...                     {'i': 2, 'j': 3, 'k': 4})
        24
    """

    def __init__(self,
                 cost_type: str = 'float64',
                 sparse_inds=None,
                 n_projs: int | None = None) -> None:
        self.cost_type = str(cost_type)
        self.sparse_inds = frozenset(() if sparse_inds is None else
                                     sparse_inds)
        if self.sparse_inds:
            if n_projs is None or int(n_projs) <= 0:
                raise ValueError("'n_projs' must be a positive number.")
            n_projs = int(n_projs)
        elif n_projs is not None:
            n_projs = int(n_projs)
            if n_projs <= 0:
                raise ValueError("'n_projs' must be a positive number.")
        self.n_projs = n_projs

    def contraction_cost(self, inds_in1, inds_in2, inds_out, dims):
        """Exact cost of contracting ``in1, in2 -> out`` (bigint/float).

        Reference formula: simple.hpp:65-83 (dense),
        simple_sparse_inds.hpp:37-49 (sparse cap).
        """
        inds_in1, inds_in2 = frozenset(inds_in1), frozenset(inds_in2)
        inds_out = frozenset(inds_out)
        if not inds_out.issubset(inds_in1 | inds_in2):
            raise ValueError(
                "'inds_out' must be a subset of 'inds_in1 | inds_in2'.")
        union = inds_in1 | inds_in2

        def prod(labels):
            return fts.reduce(op.mul, (dims[x] for x in labels), 1)

        if not self.sparse_inds:
            return prod(union)
        dense = prod(union - self.sparse_inds)
        sparse = prod(union & self.sparse_inds)
        return dense * min(sparse, self.n_projs)

    def device_params(self, inds_order) -> dict:
        """Engine inputs: ``sparse_lanes`` (``uint32 [W]``, the sparse
        indices' bits in ``inds_order``) and ``log2_n_projs``
        (``float32``), or two Nones for a dense model."""
        if not self.sparse_inds:
            return {'sparse_lanes': None, 'log2_n_projs': None}
        n_inds = len(inds_order)
        positions = [i for i, x in enumerate(inds_order)
                     if x in self.sparse_inds]
        lanes = Bitset(positions, n=n_inds).lanes(n_lanes(n_inds))
        return {
            'sparse_lanes': np.asarray(lanes, dtype=np.uint32),
            'log2_n_projs': np.float32(math.log2(self.n_projs)),
        }

    def __eq__(self, other: Any) -> bool:
        return (type(self) is type(other) and
                self.sparse_inds == other.sparse_inds and
                self.n_projs == other.n_projs)

    def __repr__(self) -> str:
        if self.sparse_inds:
            return (f'SimpleCostModelSparseInds(n_projs={self.n_projs}, '
                    f'cost_type={self.cost_type})')
        return f'SimpleCostModel(cost_type={self.cost_type})'

    def __reduce__(self):
        return type(self), (self.cost_type,
                            tuple(self.sparse_inds) or None, self.n_projs)

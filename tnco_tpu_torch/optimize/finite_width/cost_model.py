"""Label-space finite-width cost models.

Reference: tnco/optimize/finite_width/cost_model.py:44-427 and
include/tnco/optimize/finite_width/cost_model/{simple,simple_sparse_inds}.hpp.

The width of a tensor is the sum of log2 dims of its indices (sparse part
capped at ``log2 n_projs``); the contraction cost counts the union
``in1 | in2 | slices`` because sliced dims multiply every contraction.
"""

import functools as fts
import math
import operator as op
from typing import Any

from tnco_tpu_torch.optimize.infinite_memory.cost_model import (
    SimpleCostModel as _IMCostModel)

__all__ = ['SimpleCostModel']


class SimpleCostModel(_IMCostModel):
    """Finite-width cost model: widths + slice-aware contraction costs.

    Args:
        max_width: Maximum allowed (post-slicing) tensor width.
        cost_type / width_type: numeric tags kept for API parity.
        sparse_inds / n_projs: sparse-index support.

    Examples:
        >>> from tnco_tpu_torch.optimize.finite_width import SimpleCostModel
        >>> cm = SimpleCostModel(max_width=2)
        >>> cm.width({'i', 'j'}, {'i': 2, 'j': 2})
        2.0
    """

    def __init__(self,
                 max_width: float,
                 cost_type: str = 'float64',
                 width_type: str = 'float32',
                 sparse_inds=None,
                 n_projs: int | None = None) -> None:
        if max_width is None or max_width < 0:
            raise ValueError("'max_width' must be a non-negative number.")
        super().__init__(cost_type=cost_type, sparse_inds=sparse_inds,
                         n_projs=n_projs)
        self.max_width = float(max_width)
        self.width_type = str(width_type)

    def width(self, inds, dims) -> float:
        """Tensor width: sum of log2 dims, sparse part capped.

        Reference: simple.hpp:38-57, simple_sparse_inds.hpp:38-51.
        """
        inds = frozenset(inds)
        if not self.sparse_inds:
            return float(sum(math.log2(dims[x]) for x in inds))
        dense = sum(math.log2(dims[x]) for x in inds - self.sparse_inds)
        sparse = sum(math.log2(dims[x]) for x in inds & self.sparse_inds)
        return float(dense + min(sparse, math.log2(self.n_projs)))

    def delta_width(self, inds, dims, x) -> float:
        """Width change from toggling index ``x``.

        Reference: simple.hpp:59-76, simple_sparse_inds.hpp:53-79.
        """
        inds = frozenset(inds)
        if x in self.sparse_inds:
            toggled = inds ^ {x}
            cap = math.log2(self.n_projs)
            old_sp = sum(math.log2(dims[i])
                         for i in inds & self.sparse_inds)
            new_sp = sum(math.log2(dims[i])
                         for i in toggled & self.sparse_inds)
            return float(min(new_sp, cap) - min(old_sp, cap))
        sign = 1 - 2 * (x in inds)
        return float(sign * math.log2(dims[x]))

    def contraction_cost(self, inds_in1, inds_in2, inds_out, dims,
                         slices=frozenset()):
        """Exact cost over ``in1 | in2 | slices`` (sparse min-capped).

        Reference: simple.hpp:124-145, simple_sparse_inds.hpp:135-155.
        """
        inds_in1, inds_in2 = frozenset(inds_in1), frozenset(inds_in2)
        inds_out = frozenset(inds_out)
        if not inds_out.issubset(inds_in1 | inds_in2):
            raise ValueError(
                "'inds_out' must be a subset of 'inds_in1 | inds_in2'.")
        union = inds_in1 | inds_in2 | frozenset(slices)

        def prod(labels):
            return fts.reduce(op.mul, (dims[x] for x in labels), 1)

        if not self.sparse_inds:
            return prod(union)
        dense = prod(union - self.sparse_inds)
        sparse = prod(union & self.sparse_inds)
        return dense * min(sparse, self.n_projs)

    def get_max_width(self, ts_inds, dims) -> float:
        """Maximum width over a list of index sets."""
        return max(self.width(xs, dims) for xs in ts_inds)

    def __eq__(self, other: Any) -> bool:
        return (super().__eq__(other) and
                self.max_width == other.max_width)

    def __repr__(self) -> str:
        return (f'SimpleCostModel(max_width={self.max_width}, '
                f'width_type={self.width_type}, '
                f'cost_type={self.cost_type})')

    def __reduce__(self):
        return type(self), (self.max_width, self.cost_type,
                            self.width_type,
                            tuple(self.sparse_inds) or None, self.n_projs)

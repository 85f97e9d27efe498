"""Finite-width (memory-constrained) cost model."""

from tnco_tpu_torch.optimize.finite_width.cost_model import SimpleCostModel

__all__ = ['SimpleCostModel']

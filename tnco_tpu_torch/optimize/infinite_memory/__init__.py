"""Infinite-memory (unconstrained) cost model."""

from tnco_tpu_torch.optimize.infinite_memory.cost_model import SimpleCostModel

__all__ = ['SimpleCostModel']

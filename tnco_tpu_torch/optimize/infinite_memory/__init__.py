"""Infinite-memory (unconstrained) cost model and SA optimizer wrapper."""

from tnco_tpu_torch.optimize.infinite_memory.cost_model import SimpleCostModel
from tnco_tpu_torch.optimize.infinite_memory.optimizer import Optimizer

__all__ = ['Optimizer', 'SimpleCostModel']

"""Finite-width (memory-constrained) cost model and SA optimizer
wrapper."""

from tnco_tpu_torch.optimize.finite_width.cost_model import SimpleCostModel
from tnco_tpu_torch.optimize.finite_width.optimizer import Optimizer

__all__ = ['Optimizer', 'SimpleCostModel']

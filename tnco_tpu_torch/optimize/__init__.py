"""Optimizer wrappers: the label-space API over the device engines (cost
models, the single-optimizer wrappers and the acceptance
probabilities), as the reference's ``tnco/optimize`` layer."""

from tnco_tpu_torch.optimize import prob

__all__ = ['prob']

"""User-facing API: TN model, ingestion, the optimizer factory."""

from tnco_tpu_torch.app.app import dump_results, load_tn, Optimizer
from tnco_tpu_torch.app.tn import Tensor, TensorNetwork

__all__ = ['Tensor', 'TensorNetwork', 'load_tn', 'dump_results', 'Optimizer']

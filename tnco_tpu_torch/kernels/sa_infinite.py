"""Static SA configuration (from ``tnco_tpu/kernels/sa_infinite.py:41``)."""

from dataclasses import dataclass

__all__ = ['SweepConfig', 'NULL']

NULL = -1


@dataclass(frozen=True)
class SweepConfig:
    """Static kernel configuration."""
    n_leaves: int
    n_lanes: int
    disable_shared_inds: bool = False
    prob_kind: str = 'mh'  # 'mh' | 'greedy' | 'base'
    use_sparse: bool = False

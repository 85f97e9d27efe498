"""Replica-batch runtime: many independent SA chains as one device batch,
and the host fan-out of per-seed callables (``Parallel``, ``Buffer``)."""

from tnco_tpu_torch.parallel.host import Buffer, Parallel
from tnco_tpu_torch.parallel.replicas import ReplicaRunner, ReplicaRunnerFW

__all__ = ['ReplicaRunner', 'ReplicaRunnerFW', 'Parallel', 'Buffer']

"""Replica-batch runtime: many independent SA chains as one device batch."""

from tnco_tpu_torch.parallel.replicas import ReplicaRunner, ReplicaRunnerFW

__all__ = ['ReplicaRunner', 'ReplicaRunnerFW']

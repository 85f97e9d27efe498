"""Replica-batch runtime: many independent SA chains as one device batch
(split over the ranks of a replica mesh when there are several devices),
and the host fan-out of per-seed callables (``Parallel``, ``Buffer``)."""

from tnco_tpu_torch.parallel.host import Buffer, Parallel
from tnco_tpu_torch.parallel.replicas import (make_mesh, ReplicaRunner,
                                              ReplicaRunnerFW,
                                              replica_sharding)

__all__ = ['ReplicaRunner', 'ReplicaRunnerFW', 'replica_sharding',
           'make_mesh', 'Parallel', 'Buffer']

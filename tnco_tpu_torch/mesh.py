"""Replica meshes over ``torch.distributed``: the port's counterpart of the
JAX package's ``make_mesh``, ``replica_sharding`` and the ``shard_map``
collectives of its sharded engines and exchanges.

JAX runs one controller over every device.  The port runs one process
per device (SPMD): every rank builds the runner with all trees and seeds,
keeps its own block of the replica axis on its device, and meets the
other ranks in collectives.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the whole default
process group; the replica axis is split over all its axes in row-major
order, as ``PartitionSpec(axes)`` splits it.

The collectives here are all-reduces (``SUM``, ``MIN``, ``MAX``), the op
that both NCCL and gloo take on CUDA and CPU tensors.  A row that one
rank owns reaches the others as a masked sum: the owner contributes its
words, every other rank zeros, with float words summed as their integer
bit patterns, so the result is the owner's bits.

:func:`spawn` starts ranks of one process group on this host (gloo on the
CPU, NCCL with one rank per card) for the tests and the dry run; under
``torchrun --nproc-per-node N`` the caller initialises the group itself.
"""

import dataclasses
from datetime import timedelta
import math
import multiprocessing
import os
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist

__all__ = ['make_mesh', 'replica_sharding', 'ReplicaBlock', 'check_mesh',
           'rank_device',
           'axes_group', 'all_reduce', 'sum_counts', 'gather_blocks',
           'owner_rows', 'spawn']


def make_mesh(devices=None, axis_name: str = 'r', *, shape=None,
              axis_names=None):
    """Replica mesh over every rank of the initialised default group.

    1-D (``(world_size,)``, axis ``axis_name``) by default.  Pass
    ``shape``/``axis_names`` for an N-D mesh, e.g. ``make_mesh(shape=(2,
    2), axis_names=('dcn', 'ici'))``: the replica axis is split over all
    axes, while the exchange can be kept to some of them.  ``devices`` is
    the mesh's device type, ``'cuda'`` or ``'cpu'``; None takes ``'cuda'``
    under NCCL and ``'cpu'`` under gloo (whose groups may still carry
    CUDA tensors).
    """
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialised default process group: start "
            "the ranks with torchrun (or tnco_tpu_torch.mesh.spawn) and "
            "call torch.distributed.init_process_group first.")
    world = dist.get_world_size()
    if devices is None:
        devices = 'cuda' if dist.get_backend() == 'nccl' else 'cpu'
    if shape is None:
        shape, axis_names = (world,), (axis_name,)
    else:
        shape = tuple(int(s) for s in shape)
        if axis_names is None:
            axis_names = tuple(f'ax{i}' for i in range(len(shape)))
    if math.prod(shape) != world:
        raise ValueError(f"A mesh of shape {shape} needs {math.prod(shape)} "
                         f"ranks; the process group has {world}.")
    return init_device_mesh(str(devices), shape,
                            mesh_dim_names=tuple(axis_names))


@dataclasses.dataclass(frozen=True)
class ReplicaBlock:
    """This rank's block of a replica axis split into ``count`` equal
    contiguous blocks: block ``index``."""
    index: int
    count: int

    def bounds(self, n_replicas: int) -> tuple[int, int]:
        """``(lo, hi)``: the rank's replicas of ``n_replicas``."""
        if n_replicas % self.count:
            raise ValueError(f"{n_replicas} replicas do not split evenly "
                             f"over the {self.count} ranks of the mesh.")
        size = n_replicas // self.count
        return self.index * size, (self.index + 1) * size


def check_mesh(mesh) -> None:
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError("mesh must be a torch.distributed DeviceMesh "
                        f"(make_mesh), got {type(mesh).__name__}.")
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"The mesh has {mesh.size()} ranks; it must span "
                         f"the process group's {dist.get_world_size()}.")


def _axes(mesh, axis_names) -> tuple:
    names = tuple(mesh.mesh_dim_names)
    if axis_names is None:
        return names
    axes = (axis_names,) if isinstance(axis_names, str) else \
        tuple(axis_names)
    unknown = [a for a in axes if a not in names]
    if unknown or len(set(axes)) != len(axes):
        raise ValueError(f"{axes} do not name distinct axes of the mesh "
                         f"{names}.")
    return axes


def _linear(mesh, axes) -> tuple[int, int]:
    """(this rank's row-major index over ``axes``, their size)."""
    names = tuple(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    index, size = 0, 1
    for ax in axes:
        n = mesh.shape[names.index(ax)]
        index = index * n + coord[names.index(ax)]
        size *= n
    return index, size


def replica_sharding(mesh, axis_name=None) -> ReplicaBlock:
    """This rank's block of the replica axis, split over ALL mesh axes in
    row-major order, or over ``axis_name`` (one axis name or several, in
    the order given) and repeated along the others, as
    ``PartitionSpec(axis_name)`` splits it."""
    check_mesh(mesh)
    return ReplicaBlock(*_linear(mesh, _axes(mesh, axis_name)))


def rank_device(device=None) -> torch.device:
    """A rank's device: ``'cpu'`` when asked for, else the card
    ``cuda:<LOCAL_RANK>`` (modulo the cards present, so that several gloo
    ranks may share one card)."""
    from tnco_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type == 'cuda' and dev.index is None:
        local = int(os.environ.get('LOCAL_RANK', dist.get_rank()))
        dev = torch.device('cuda', local % torch.cuda.device_count())
    return dev


def axes_group(mesh, axis_names=None):
    """``(group, index, size)``: the process group of the ranks that
    differ from this one only along ``axis_names`` (default: all axes),
    this rank's row-major index over those axes (in the order given), and
    the group's size.  Groups over several but not all axes are built once
    per mesh, by every rank (the call is collective)."""
    check_mesh(mesh)
    axes = _axes(mesh, axis_names)
    index, size = _linear(mesh, axes)
    names = tuple(mesh.mesh_dim_names)
    if set(axes) == set(names):
        return dist.group.WORLD, index, size
    if len(axes) == 1:
        return mesh.get_group(axes[0]), index, size
    cache = mesh.__dict__.setdefault('_tnco_axes_groups', {})
    if axes not in cache:
        order = [names.index(a) for a in names if a not in axes] + \
            [names.index(a) for a in axes]
        rows = mesh.mesh.permute(order).reshape(-1, size).tolist()
        cache[axes], _ = dist.new_subgroups_by_enumeration(rows)
    return cache[axes], index, size


_OPS = {'sum': 'SUM', 'min': 'MIN', 'max': 'MAX'}


def all_reduce(x: torch.Tensor, op: str = 'sum', group=None) -> torch.Tensor:
    """All-reduce of a copy of ``x`` over ``group`` (default: every rank)
    with ``op`` in 'sum', 'min', 'max'; returns the result."""
    out = x.clone()
    dist.all_reduce(out, op=getattr(dist.ReduceOp, _OPS[op]), group=group)
    return out


def sum_counts(metrics: dict, device) -> dict:
    """``metrics`` with ``moves`` and ``applied`` summed over every rank,
    as int64 scalars on ``device`` (the JAX sharded engines' ``psum``)."""
    out = dict(metrics)
    for k in ('moves', 'applied'):
        if k in metrics:
            local = torch.as_tensor(metrics[k], device=device).sum(
                dtype=torch.int64)
            out[k] = all_reduce(local, 'sum')
    return out


def _words(x: torch.Tensor) -> torch.Tensor:
    """``x`` (32- or 64-bit) as flat int32 words, floats as their bits."""
    return x.contiguous().reshape(-1).view(torch.int32)


def owner_rows(parts, owner: bool, group=None) -> list:
    """The owner's ``parts`` (a list of 32- or 64-bit tensors) on every
    rank of ``group``, by one masked sum of their words: exactly one rank
    passes ``owner=True``; the others pass tensors of the same shapes and
    types (their values are ignored)."""
    words = torch.cat([_words(p) for p in parts])
    if not owner:
        words = torch.zeros_like(words)
    words = all_reduce(words, 'sum', group)
    out, at = [], 0
    for p in parts:
        n = p.numel() * p.element_size() // 4
        out.append(words[at:at + n].view(p.dtype).reshape(p.shape))
        at += n
    return out


def gather_blocks(x: torch.Tensor, block: ReplicaBlock) -> torch.Tensor:
    """The whole replica axis of ``x`` (this rank's block of it along the
    last axis) on every rank, in mesh order, by a masked sum."""
    size = x.shape[-1]
    full = torch.zeros(x.shape[:-1] + (size * block.count,), dtype=x.dtype,
                       device=x.device)
    full[..., block.index * size:(block.index + 1) * size] = x
    (out,) = owner_rows([full], True)
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, n_ranks, port, backend, args, threads, results):
    os.environ['LOCAL_RANK'] = str(rank)
    if threads:
        torch.set_num_threads(threads)
    try:
        if backend == 'nccl':
            torch.cuda.set_device(rank)
        dist.init_process_group(backend, init_method=f'tcp://127.0.0.1:{port}',
                                world_size=n_ranks, rank=rank,
                                timeout=timedelta(seconds=120))
        try:
            value = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, value))
    except Exception:                          # reported by the parent
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, n_ranks: int, args=(), *, backend: str = 'gloo',
          timeout: float = 300.0, threads: int | None = None) -> list:
    """Runs ``fn(*args)`` on ``n_ranks`` new processes that form one
    process group on this host (``tcp://127.0.0.1`` on a free port; gloo,
    or NCCL with rank ``r`` on ``cuda:r``), and returns the ranks' results
    in rank order.  ``fn`` must be importable by name (the ranks start
    from a fresh interpreter).  ``threads`` caps each rank's torch
    threads (default: the cores shared out).  Raises ``RuntimeError``,
    naming each failed rank with its traceback or exit code, when a rank
    fails or the ranks outlast ``timeout`` seconds; every rank is stopped
    before it returns."""
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // n_ranks)
    ctx = multiprocessing.get_context('spawn')
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, n_ranks, port, backend, tuple(args),
                               threads, results), daemon=True)
             for r in range(n_ranks)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + timeout
    try:
        while len(got) < n_ranks:
            try:
                rank, ok, value = results.get(
                    timeout=max(0.1, min(5.0, deadline - time.monotonic())))
            except queue.Empty:
                if time.monotonic() > deadline or any(
                        p.exitcode not in (None, 0) for p in procs):
                    break
                continue
            got[rank] = (ok, value)
            if not ok:
                break
    finally:
        for p in procs:
            p.join(timeout=max(0.1, min(10.0, deadline - time.monotonic())))
        while len(got) < n_ranks:
            try:
                rank, ok, value = results.get(timeout=0.1)
            except queue.Empty:
                break
            got[rank] = (ok, value)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    failed = [f"rank {r}: {got[r][1]}" if r in got else
              f"rank {r}: no result (exit code {procs[r].exitcode})"
              for r in range(n_ranks) if r not in got or not got[r][0]]
    if failed:
        raise RuntimeError(f"{len(failed)} of {n_ranks} ranks failed:\n" +
                           '\n'.join(failed))
    return [got[r][1] for r in range(n_ranks)]

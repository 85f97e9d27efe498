"""Replica runners (the port of ``tnco_tpu/parallel/replicas.py``):
:class:`ReplicaRunner` (infinite memory, engines 'batched', 'vmapped',
'walks', 'walker', 'multiwalk', 'sweep' and 'native') and
:class:`ReplicaRunnerFW` (finite width, the same engines), and
the population operators that run between chunks: island exchange
(:func:`exchange_best`, :func:`exchange_best_fw`, and on a mesh
:func:`exchange_best_sharded`, :func:`exchange_best_fw_sharded`) and the
slice-kick (:func:`kick_lanes_fw`).  Both runners take a sparse cost
model (every engine but 'walker', which refuses it as the JAX walker
does).

Replicas of one connected component share array shapes, so a batch is
one stacked state on one device; ``run`` anneals it in chunks with a
wall-clock budget and host callbacks (and, finite width, re-derives the
slice set every ``update_slices`` steps, reference finite_width/sa.py:
228).  'native' keeps its state in host numpy and anneals it with the
multithreaded C++ engine of :mod:`tnco_tpu_torch.native`.

On a mesh (``mesh=``, :func:`make_mesh`) every rank of the process group
builds the runner with all trees and seeds and keeps its own block of the
replicas on its device (:func:`replica_sharding`); the engines run on the
block, their draws are the one-device run's columns
(:class:`~tnco_tpu_torch.ops.rng.BlockGenerator`), so a sharded run
equals the one-device run bitwise, and the accessors are collectives.
"""

import dataclasses
from random import Random
import time
from warnings import warn

import numpy as np
import torch

from tnco_tpu_torch import mesh as tmesh
from tnco_tpu_torch import native
from tnco_tpu_torch.device import resolve_device
from tnco_tpu_torch.kernels import sa_batched as sb
from tnco_tpu_torch.kernels import sa_finite as saf
from tnco_tpu_torch.kernels import sa_finite_batched as sfb
from tnco_tpu_torch.kernels import sa_fullsweep as sfs
from tnco_tpu_torch.kernels import sa_infinite as sa
from tnco_tpu_torch.kernels import sa_multiwalk as smw
from tnco_tpu_torch.kernels import sa_walks as swk
from tnco_tpu_torch.kernels import walker as kwalker
from tnco_tpu_torch.kernels.sa_finite import (SweepConfigFW,
                                              greedy_slices_host)
from tnco_tpu_torch.kernels.sa_fullsweep import uniform_log2_dim
from tnco_tpu_torch.kernels.sa_infinite import SweepConfig
from tnco_tpu_torch.mesh import make_mesh, replica_sharding
from tnco_tpu_torch.ops import bitops
from tnco_tpu_torch.ops import costs as costs_ops
from tnco_tpu_torch.ops import rng
from tnco_tpu_torch.utils.profiling import host_read, span

__all__ = ['ReplicaRunner', 'ReplicaRunnerFW', 'exchange_best',
           'exchange_best_fw', 'exchange_best_sharded',
           'exchange_best_fw_sharded', 'kick_lanes_fw', 'make_mesh',
           'replica_sharding']

_ENGINES = ('batched', 'vmapped', 'native', 'multiwalk', 'walker', 'sweep',
            'walks')
# Engines whose state keeps the replica axis last; exchange and the kick
# run on them only ('vmapped' keeps replica-major states), as in the JAX
# runners.
_LANE_MAJOR = ('batched', 'walks', 'walker', 'multiwalk', 'sweep')
# Engines with no multi-device path: the runners refuse a mesh for them,
# as the JAX runners do (replicas.py:57-63).
_MESHLESS = ('sweep',)
# The engines that take the walk options (on_block, accept_rule).
_WALK_ENGINES = ('multiwalk', 'walks')


def _accel_available(device: torch.device) -> bool:
    """True when the runner's device is the card (the 'auto' rule's
    "accelerator present"; tests monkeypatch it to pin the routing)."""
    return device.type == 'cuda'


def _native_available() -> bool:
    """Whether the native C++ engine can run on this host (the library
    builds, ``TNCO_TPU_NO_NATIVE`` is unset); the 'auto' rule's "native
    available".  A compile error of ``native/core.cpp`` raises."""
    return native.available()


def resolve_engine(n_nodes: int, n_lanes: int, *, accel: bool,
                   native: bool, sparse: bool, max_new_slices: int,
                   disable_shared_inds: bool, prob_kind,
                   fw: bool = True) -> str:
    """The JAX runners' 'auto' rule (``replicas.py:689-708`` finite
    width, ``:282-301`` infinite memory with ``fw=False``): small states
    go to 'batched', large dense ones on a device to 'walks' (FW) or
    'walker' (IM), large dense ones elsewhere to 'native' where it is
    available (``native``), the rest (sparse indices, new slices, other
    accept rules) to 'vmapped'."""
    if n_nodes * n_lanes <= 32768 and max_new_slices == 0:
        return 'batched'
    if (accel and not sparse and max_new_slices == 0 and
            prob_kind in (None, 'mh')):
        return 'walks' if fw else 'walker'
    if (native and not sparse and not disable_shared_inds and
            prob_kind in (None, 'mh')):
        return 'native'
    return 'vmapped'


def _resolve_walks(engine: str, n_walks, fw: bool = False) -> int:
    """Walks per replica, the JAX runners' defaults (``replicas.py:
    135-149``): 'walks' 128 finite width and 32 infinite memory, every
    other walk engine ('walker', 'multiwalk') 8."""
    if n_walks is not None:
        return int(n_walks)
    if engine == 'walks':
        return 128 if fw else 32
    return 8


def _resolve_on_block(on_block, engine: str) -> str:
    """Walk scheduling on a claim's discard (``replicas.py:152-165``):
    None means 'advance'; the others run on 'multiwalk' and 'walks'
    only."""
    if on_block is None:
        return 'advance'
    if on_block not in smw._ON_BLOCK:
        raise ValueError(f"on_block must be one of {smw._ON_BLOCK}, "
                         f"got {on_block!r}.")
    if on_block != 'advance' and engine not in _WALK_ENGINES:
        raise ValueError(f"on_block={on_block!r} is only supported by "
                         "the 'multiwalk' and 'walks' engines "
                         f"(engine={engine!r}).")
    return on_block


def _resolve_accept_rule(accept_rule, engine: str) -> str:
    """'round' (every walk against the pre-round total) or 'chained'
    (against the running total of the kept walks before it;
    ``replicas.py:168-182``): None means 'round'; 'chained' runs on
    'multiwalk' and 'walks' only."""
    if accept_rule is None:
        return 'round'
    if accept_rule not in ('round', 'chained'):
        raise ValueError("accept_rule must be 'round' or 'chained', "
                         f"got {accept_rule!r}.")
    if accept_rule != 'round' and engine not in _WALK_ENGINES:
        raise ValueError(f"accept_rule={accept_rule!r} is only supported "
                         "by the 'multiwalk' and 'walks' engines "
                         f"(engine={engine!r}).")
    return accept_rule


def _resolve_prob_kind(prob_kind, engine: str) -> str:
    """None means 'mh_local' on 'sweep' and 'mh' on every other engine;
    'mh_local' runs on 'sweep' and 'walks' only (``replicas.py:
    312-317``)."""
    if prob_kind is None:
        return 'mh_local' if engine == 'sweep' else 'mh'
    if prob_kind == 'mh_local' and engine not in ('sweep', 'walks'):
        raise ValueError("prob_kind='mh_local' is only supported by "
                         "the 'sweep' and 'walks' engines.")
    return prob_kind


def _check_walk_options(runner) -> None:
    """The walk engines' option checks, when the runner is built:
    'multiwalk' its ``prob_kind`` and ``walk_chunk`` (at least 0,
    dividing ``n_walks``), 'walks' its ``prob_kind`` ('walks' takes no
    ``walk_chunk``, as in the JAX runner)."""
    if runner.engine == 'multiwalk':
        smw.check_options(runner.cfg, runner.on_block, runner.accept_rule)
        smw.walk_groups(runner.n_walks, runner.walk_chunk)
    elif runner.engine == 'walks':
        swk._check_options(runner.cfg, 'sequential', runner.on_block,
                           runner.accept_rule)


def _check_meshless(engine: str, mesh) -> None:
    if mesh is not None and engine in _MESHLESS:
        raise ValueError(
            f"engine={engine!r} has no multi-chip execution path "
            "(its kernels run on one device; there is no sharded form).  "
            "Use engine='walks' (sharded path, same chained-walk "
            "semantics) or drop the mesh.")


def _runner_device(device, mesh) -> torch.device:
    """The device rule; on a mesh, the rank's device
    (:func:`~tnco_tpu_torch.mesh.rank_device`)."""
    if mesh is None:
        return resolve_device(device)
    tmesh.check_mesh(mesh)
    return tmesh.rank_device(device)


def _set_block(runner, n: int) -> tuple[int, int]:
    """Sets and returns this rank's replicas ``[lo, hi)`` of ``n`` (all of
    them without a mesh, and on 'native', which runs every replica on
    each rank's host as the JAX runner does with a mesh)."""
    runner._block = (None if runner.mesh is None or runner.engine == 'native'
                     else replica_sharding(runner.mesh))
    runner._lo, runner._hi = ((0, n) if runner._block is None else
                              runner._block.bounds(n))
    return runner._lo, runner._hi


def _sparse_params(cmodel, template, device):
    """``(sparse_lanes int32 [W], sparse_wb [W, 1], log2_n_projs)`` of a
    sparse cost model over the template's index order, on ``device``;
    three Nones for a dense one (``replicas.py:272-281``)."""
    if cmodel is None or not getattr(cmodel, 'sparse_inds', None):
        return None, None, None
    dev = cmodel.device_params(template.inds_order)
    lanes = bitops.as_lanes(dev['sparse_lanes'], device)
    return lanes, lanes[:, None], dev['log2_n_projs']


def _warn_exchange(engine: str) -> None:
    warn(f"exchange_every is only supported by the {_LANE_MAJOR} engines "
         f"(engine={engine!r}); ignored.")


def _check_betas(betas, n_replicas: int, dtype=torch.float32) -> np.ndarray:
    """``betas`` as host rows of the runner's float type: ``[n]``, or
    ``[n, B]``, one beta per lane (a tempering ladder; the walker refuses
    those)."""
    betas = np.asarray(betas, dtype=np.float64 if dtype == torch.float64
                       else np.float32)
    if betas.ndim not in (1, 2) or (betas.ndim == 2 and
                                    betas.shape[1] != n_replicas):
        raise ValueError(f"betas must be [n] or [n, {n_replicas}], got "
                         f"{betas.shape}.")
    return betas


class ReplicaRunner:
    """Infinite-memory replica batch on one device, or on one rank's
    device of a mesh.

    Args:
        ctrees: One initial ``ContractionTree`` per replica (same shape).
        seeds: One integer seed per replica (the batch's
            ``torch.Generator`` is seeded from all of them; 'native'
            seeds one mt19937 stream per replica and chunk).
        cmodel: Infinite-memory cost model; a sparse one caps every
            cost's sparse part at ``log2(n_projs)`` ('walker' refuses it,
            as the JAX walker does).
        disable_shared_inds, prob_kind: Kernel flags; ``prob_kind`` None
            means 'mh_local' on 'sweep', else 'mh'; 'mh_local' runs on
            'sweep' and 'walks' only.
        mesh: a ``DeviceMesh`` (:func:`make_mesh`) to split the replicas
            over, or None.  On a mesh every rank builds the runner with
            all trees and seeds, keeps its block on its device
            (``cuda:<LOCAL_RANK>``, or the CPU when ``device='cpu'``), and
            calls ``run`` and the accessors with the other ranks; the
            replica count must divide by the mesh size.  'sweep' refuses
            a mesh, as in the JAX runner; 'native' runs every replica on
            each rank's host.
        engine: 'auto', 'batched', 'vmapped', 'walks', 'walker',
            'multiwalk', 'sweep' or 'native'.  'auto' resolves by the JAX
            runner's rule (``replicas.py:282-301``: 'batched' for N*W <=
            32768, else 'walker' on the card for a dense model, else
            'native' where :func:`_native_available`, else 'vmapped').
            'vmapped' keeps replica-major :class:`~tnco_tpu_torch.
            kernels.sa_infinite.SAStateIM` states and runs the lockstep
            sweep on them (equal to 'batched' on the same draws).
            'walks' runs :func:`~tnco_tpu_torch.kernels.sa_walks.
            run_walks` (rows through K1 and K3); 'sweep' runs
            :func:`~tnco_tpu_torch.kernels.sa_fullsweep.run_fullsweep`
            (a proposal at every node a round, rows through K1; 'auto'
            never picks it).  'native' anneals host numpy trees with the
            C++ engine (:func:`tnco_tpu_torch.native.sa_run`, one sweep
            per beta, bitwise the JAX package's 'native').
        n_walks: Walks per replica (default 32 for 'walks', 8 for
            'walker' and 'multiwalk'; not used by the lockstep engines).
        walk_chunk: 'multiwalk' evaluates its walks in groups of this
            size (0: one group; the results are the same).
        on_block, accept_rule: 'multiwalk' and 'walks' options (see
            :func:`~tnco_tpu_torch.kernels.sa_multiwalk.run_multiwalk`).
        dtype: the device float type, ``torch.float32`` or (under the
            float64 mode, :func:`~tnco_tpu_torch.ops.bitops.
            device_dtype`) ``torch.float64``; the walker refuses float64.
        device: ``None`` means ``'cuda'``; pass ``'cpu'`` explicitly.
    """

    def __init__(self,
                 ctrees,
                 seeds,
                 *,
                 cmodel=None,
                 disable_shared_inds: bool = False,
                 prob_kind: str | None = None,
                 mesh=None,
                 engine: str = 'auto',
                 n_walks: int | None = None,
                 walk_chunk: int = 0,
                 on_block: str | None = None,
                 accept_rule: str | None = None,
                 dtype=torch.float32,
                 device=None) -> None:
        _check_meshless(engine, mesh)
        self.device = _runner_device(device, mesh)
        ctrees = list(ctrees)
        seeds = [int(s) for s in seeds]
        if len(ctrees) != len(seeds):
            raise ValueError("One seed per replica is required.")
        if not ctrees:
            raise ValueError("'ctrees' cannot be empty.")
        shapes = {(len(c), c.inds_array.shape[1]) for c in ctrees}
        if len(shapes) != 1:
            raise ValueError("All replicas must share the tree shape.")

        self.template = ctrees[0]
        n_lanes = self.template.inds_array.shape[1]
        self.sparse_lanes, self.sparse_wb, self.log2_n_projs = \
            _sparse_params(cmodel, self.template, self.device)
        if engine == 'auto':
            engine = resolve_engine(
                len(self.template), n_lanes,
                accel=_accel_available(self.device),
                native=_native_available(),
                sparse=self.sparse_lanes is not None, max_new_slices=0,
                disable_shared_inds=disable_shared_inds,
                prob_kind=prob_kind, fw=False)
        if engine not in _ENGINES:
            raise ValueError(f"Unknown engine: {engine!r}")
        if engine == 'walker':
            kwalker.dense_only(self.sparse_wb)
            kwalker.float32_only(dtype)
        prob_kind = _resolve_prob_kind(prob_kind, engine)
        if engine == 'walker' and not kwalker.walker_supported(
                len(self.template), self.template.n_leaves, n_lanes):
            raise ValueError(
                f"engine='walker' does not run on N={len(self.template)}, "
                f"W={n_lanes} (kernels.walker.walker_supported).")
        self.cfg = SweepConfig(n_leaves=self.template.n_leaves,
                               n_lanes=n_lanes,
                               disable_shared_inds=disable_shared_inds,
                               prob_kind=prob_kind)
        self.engine = engine
        self.n_walks = _resolve_walks(engine, n_walks)
        self.walk_chunk = int(walk_chunk)
        self.on_block = _resolve_on_block(on_block, engine)
        self.accept_rule = _resolve_accept_rule(accept_rule, engine)
        _check_walk_options(self)
        self.dtype = dtype
        self.mesh = mesh
        self.n_replicas = len(ctrees)
        self.sweeps_done = 0
        self.moves_done = 0
        self.applied_done = None
        self.log2d = bitops.pad_log2_dims(self.template.log2_dims_array,
                                          n_lanes, dtype, self.device)
        self.log2d_w32 = self.log2d.reshape(n_lanes, 32)
        self.uniform_log2 = uniform_log2_dim(self.template.log2_dims_array)
        lo, hi = _set_block(self, len(ctrees))
        if engine == 'native':
            _init_native(self, ctrees, seeds)
            return

        self.states = sb.init_batch(
            ctrees[lo:hi], seeds[lo:hi], self.log2d.cpu().numpy(),
            sparse_lanes=_host_lanes(self.sparse_lanes),
            log2_n_projs=self.log2_n_projs,
            dtype=self.log2d.cpu().numpy().dtype, device=self.device)
        if engine == 'vmapped':
            self.states = sa.from_batch(self.states)
        _init_draws(self, seeds)

    def run(self,
            betas,
            *,
            chunk_size: int = 128,
            timeout: float | None = None,
            callback=None,
            exchange_every: int = 0,
            exchange_fraction: float = 0.25,
            exchange_islands: int = 1,
            exchange_axes=None) -> dict:
        """Runs one iteration (a sweep for 'batched') per beta in chunks
        of ``chunk_size`` (the last chunk padded with its last beta, as in
        the JAX runner), drawing the streams from the batch's generator.
        ``betas`` is ``[n]`` or per lane ``[n, B]`` (a tempering ladder;
        not on 'walker', whose kernel reads one beta per iteration, nor
        on 'native', one beta per sweep).  After each chunk the host
        checks the wall-clock budget and calls ``callback``.  'batched'
        and 'vmapped' count no applied moves (``applied`` stays None, as
        in the JAX runner).

        ``exchange_every``: every that many chunks (not after the last),
        :func:`exchange_best` restarts the worst ``exchange_fraction`` of
        each of ``exchange_islands`` islands from its best lane (the
        lane-major engines; the others warn and ignore it, as the JAX
        runner does).  On a mesh it is :func:`exchange_best_sharded` over
        the mesh axes ``exchange_axes`` (default: all), and
        ``exchange_islands`` is not used; without a mesh
        ``exchange_axes`` is not used.  On a mesh every rank calls
        ``run`` with the same arguments; the counts are the mesh's."""
        if exchange_every and self.engine not in _LANE_MAJOR:
            _warn_exchange(self.engine)
        if self.engine == 'native':
            return _run_native(self, betas, chunk_size, timeout, callback)
        betas = _local_betas(self, betas)
        start = time.perf_counter()
        n = len(betas)
        pos = 0
        n_chunks = 0
        chunk_size = max(1, min(chunk_size, n))
        while pos < n:
            if _out_of_time(self, start, timeout):
                break
            with span('tnco.runner.chunk', n_chunks):
                chunk = betas[pos:pos + chunk_size]
                if len(chunk) < chunk_size:
                    chunk = np.concatenate(
                        [chunk, np.repeat(chunk[-1:], chunk_size - len(chunk),
                                          axis=0)])
                chunk = torch.from_numpy(chunk).to(self.device)
                sp = (self.sparse_wb, self.log2_n_projs)
                gen = self._draws
                if self.engine == 'batched':
                    self.states, metrics = sb.run_sweeps_batched(
                        self.states, chunk, self.log2d_w32, self.cfg, *sp,
                        uniform_log2=self.uniform_log2, generator=gen)
                elif self.engine == 'vmapped':
                    self.states, metrics = sa.run_sweeps_batch(
                        self.states, chunk, self.log2d, self.cfg,
                        self.sparse_lanes, self.log2_n_projs,
                        uniform_log2=self.uniform_log2, generator=gen)
                elif self.engine == 'walker':
                    self.states, metrics = kwalker.run_walker(
                        self.states, chunk, self.log2d_w32, self.cfg,
                        self.n_walks, self._mw_pos, generator=gen)
                elif self.engine == 'sweep':
                    self.states, metrics = sfs.run_fullsweep(
                        self.states, chunk, self.log2d_w32, self.cfg, *sp,
                        uniform_log2=self.uniform_log2, generator=gen)
                elif self.engine == 'walks':
                    self.states, metrics = swk.run_walks(
                        self.states, chunk, self.log2d_w32, self.cfg,
                        self._mw_pos, *sp, uniform_log2=self.uniform_log2,
                        on_block=self.on_block, accept_rule=self.accept_rule,
                        generator=gen, device=self.device)
                else:
                    self.states, metrics = smw.run_multiwalk(
                        self.states, chunk, self.log2d_w32, self.cfg,
                        self.n_walks, self._mw_pos, *sp,
                        uniform_log2=self.uniform_log2,
                        on_block=self.on_block, accept_rule=self.accept_rule,
                        walk_chunk=self.walk_chunk, generator=gen)
                self._count(metrics, chunk_size)
            pos += chunk_size
            n_chunks += 1
            if (exchange_every and self.engine in _LANE_MAJOR and pos < n
                    and n_chunks % exchange_every == 0):
                if self.mesh is not None:
                    self.states = exchange_best_sharded(
                        self.states, self.mesh, exchange_axes,
                        exchange_fraction)
                else:
                    self.states = exchange_best(
                        self.states, exchange_fraction, exchange_islands)
            if callback is not None:
                callback({
                    'progress': min(pos, n) / n,
                    'log2_min_total': self.log2_min_totals(),
                })
        return {
            'log2_min_total': self.log2_min_totals(),
            'sweeps': self.sweeps_done,
            'moves': self.moves_done,
            'applied': self.applied_done,
            'runtime_s': time.perf_counter() - start,
        }

    def _count(self, metrics, chunk_size):
        """Adds a chunk's counts, the mesh's on a mesh (and keeps the walk
        engines' positions)."""
        with span('tnco.runner.count'):
            if self.mesh is not None:
                metrics = tmesh.sum_counts(metrics, self.device)
            self._mw_pos = metrics.get('pos', self._mw_pos)
            self.sweeps_done += chunk_size
            self.moves_done += int(torch.as_tensor(metrics['moves']).sum())
            if 'applied' in metrics:
                self.applied_done = ((self.applied_done or 0) +
                                     host_read(metrics['applied'], int))

    def best(self) -> tuple[int, float]:
        """(replica index, log2 cost) of the best replica (a collective
        on a mesh, as :meth:`log2_min_totals` is)."""
        mins = self.log2_min_totals()
        idx = int(np.argmin(mins))
        return idx, float(mins[idx])

    def _replica(self, names, replica: int) -> list:
        """The state fields ``names`` of ``replica`` (its column, or row
        of a replica-major state).  On a mesh this is a collective: every
        rank calls it, and the owner's rows reach all of them."""
        axis = 0 if self.engine == 'vmapped' else -1

        def rows(r):
            return [getattr(self.states, f).select(axis, r).contiguous()
                    for f in names]

        if self._block is None:
            return rows(replica)
        if not 0 <= replica < self.n_replicas:
            raise IndexError(f"replica {replica} of {self.n_replicas}.")
        owner = replica // (self._hi - self._lo) == self._block.index
        return tmesh.owner_rows(rows(replica - self._lo if owner else 0),
                                owner)

    def _tree(self, prefix: str, replica: int):
        """``replica``'s tree (``prefix`` 'min_': its best) as a host
        ``ContractionTree``."""
        if self.engine == 'vmapped':
            nodes, inds = self._replica((prefix + 'nodes', prefix + 'inds'),
                                        replica)
        else:
            c0, c1, par, inds = self._replica(
                tuple(prefix + f for f in ('c0', 'c1', 'par', 'inds')),
                replica)
            nodes = torch.stack([c0, c1, par], dim=1)
        return sa.state_to_ctree(self.template, nodes, inds)

    def min_ctree(self, replica: int):
        """Best tree found by ``replica`` as a host ``ContractionTree``
        (a collective on a mesh)."""
        if self.engine == 'native':
            return self.template.replace_arrays(
                self._nat_best_nodes[replica], self._nat_best_inds[replica])
        return self._tree('min_', replica)

    def ctree(self, replica: int):
        """Current (not best) tree of ``replica`` (a collective on a
        mesh)."""
        if self.engine == 'native':
            return self.template.replace_arrays(
                self._nat_nodes[replica], self._nat_inds[replica])
        return self._tree('', replica)

    def log2_min_totals(self) -> np.ndarray:
        """Every replica's best log2 total (a collective on a mesh: the
        blocks of all ranks, in mesh order)."""
        if self.engine == 'native':
            return self._nat_best.copy()
        mins = self.states.min_log2_total
        if self._block is not None:
            mins = tmesh.gather_blocks(mins, self._block)
        return mins.cpu().numpy()


def _init_draws(runner, seeds) -> None:
    """The batch's walk positions (``[P, hi - lo]``) and its generator,
    seeded alike on every rank from all the seeds; on a mesh the engines
    draw through a :class:`~tnco_tpu_torch.ops.rng.BlockGenerator`."""
    runner._mw_pos = torch.full((runner.n_walks, runner._hi - runner._lo),
                                -1, dtype=torch.int32, device=runner.device)
    runner.generator = torch.Generator(device=runner.device)
    runner.generator.manual_seed(
        int(np.random.SeedSequence(seeds).generate_state(1)[0]))
    runner._draws = (runner.generator if runner._block is None else
                     rng.BlockGenerator(runner.generator, runner._lo,
                                        runner._hi, runner.n_replicas))


def _local_betas(runner, betas) -> np.ndarray:
    """Checked ``betas``; of ``[n, B]`` ones, the rank's columns."""
    betas = _check_betas(betas, runner.n_replicas, runner.dtype)
    if betas.ndim == 1:
        return betas
    return np.ascontiguousarray(betas[:, runner._lo:runner._hi])


def _out_of_time(runner, start: float, timeout) -> bool:
    """Whether the wall-clock budget is spent; on a mesh, whether it is
    spent on any rank (a collective, so that all ranks stop after the same
    chunk)."""
    if timeout is None:
        return False
    late = time.perf_counter() - start > timeout
    if runner.mesh is None:
        return late
    flag = torch.tensor([int(late)], device=runner.device)
    return bool(tmesh.all_reduce(flag, 'max'))


def _init_native(runner, ctrees, seeds, fw: bool = False) -> None:
    """Host replica arrays of the 'native' engine (``replicas.py:371-384``;
    finite width ``:798-825``: initial slices from the host greedy slicer,
    ``Random(seed & 0x7FFFFFFF)`` jitter, the skip lanes' bits)."""
    if not native.available():
        raise RuntimeError(
            "engine='native' needs the native library, which is switched "
            "off (TNCO_TPU_NO_NATIVE) or cannot be built (no g++) here.")
    runner.states = None
    runner._nat_nodes = np.stack([c.nodes_array.copy() for c in ctrees])
    runner._nat_inds = np.stack([c.inds_array.copy() for c in ctrees])
    runner._nat_best_nodes = runner._nat_nodes.copy()
    runner._nat_best_inds = runner._nat_inds.copy()
    runner._nat_seeds = np.asarray(seeds, dtype=np.uint64)
    runner._nat_chunk = 0
    if not fw:
        costs = [c.total_cost_exact() for c in ctrees]
        runner._nat_best = np.array([
            float(np.log2(float(x))) if x > 0 else -np.inf for x in costs])
        return
    skip = runner.skip_lanes.cpu().numpy().view(np.uint32)
    shifts = np.arange(32, dtype=np.uint32)
    skip_bits = ((skip[:, None] >> shifts) & 1).astype(bool).reshape(-1)
    log2d = runner.log2d.cpu().numpy().astype(np.float64)
    runner._nat_slices = np.stack([
        greedy_slices_host(c.inds_array, log2d, float(runner.max_width),
                           Random(s & 0x7FFFFFFF), skip_bits=skip_bits)
        for c, s in zip(ctrees, seeds)])
    runner._nat_best_slices = runner._nat_slices.copy()
    runner._nat_best = np.full(len(ctrees), np.inf)


def _run_native(runner, betas, chunk_size, timeout, callback,
                update_slices=None) -> dict:
    """'native' chunks (``replicas.py:386-424``; finite width, with
    ``update_slices``, ``:827-870``): each chunk runs
    :func:`~tnco_tpu_torch.native.sa_run` (or ``sa_run_fw``) from the
    final trees of the last one, on fresh mt19937 seeds ``seeds + 1000003
    * (chunk + 1)``, and keeps each replica's best."""
    betas = np.asarray(betas, dtype=np.float64)
    if betas.ndim != 1:
        raise ValueError("engine='native' takes one beta per sweep, [n]; "
                         f"got {betas.shape}.")
    fw = update_slices is not None
    n = len(betas)
    start = time.perf_counter()
    pos = 0
    chunk_size = max(1, min(chunk_size, n))
    log2d = runner.template.log2_dims_array
    while pos < n:
        if _out_of_time(runner, start, timeout):
            break
        with span('tnco.runner.chunk', pos // chunk_size):
            chunk = betas[pos:pos + chunk_size]
            seeds = runner._nat_seeds + np.uint64(
                1000003 * (runner._nat_chunk + 1))
            if fw:
                (best, moves, runner._nat_nodes, runner._nat_inds,
                 runner._nat_slices, bn, bi, bs) = native.sa_run_fw(
                     runner._nat_nodes, runner._nat_inds, runner._nat_slices,
                     log2d, runner.skip_lanes.cpu().numpy().view(np.uint32),
                     float(runner.max_width), chunk, seeds,
                     reslice_every=update_slices, n_threads=0,
                     max_new_slices=runner.cfg.max_new_slices,
                     return_final=True)
            else:
                (best, moves, runner._nat_nodes, runner._nat_inds, bn,
                 bi) = native.sa_run(runner._nat_nodes, runner._nat_inds,
                                     log2d, chunk, seeds, n_threads=0,
                                     return_final=True)
            improved = best < runner._nat_best
            runner._nat_best = np.where(improved, best, runner._nat_best)
            runner._nat_best_nodes[improved] = bn[improved]
            runner._nat_best_inds[improved] = bi[improved]
            if fw:
                runner._nat_best_slices[improved] = bs[improved]
            runner._nat_chunk += 1
            runner.sweeps_done += len(chunk)
            runner.moves_done += moves
        pos += chunk_size
        if callback is not None:
            callback({'progress': min(pos, n) / n,
                      'log2_min_total': runner._nat_best.copy()})
    return {
        'log2_min_total': runner._nat_best.copy(),
        'sweeps': runner.sweeps_done,
        'moves': runner.moves_done,
        'applied': runner.applied_done,
        'runtime_s': time.perf_counter() - start,
    }


def _host_lanes(lanes):
    """An int32 lane tensor as host ``uint32`` words (None stays None)."""
    return None if lanes is None else \
        lanes.cpu().numpy().view(np.uint32)


class ReplicaRunnerFW:
    """Finite-width replica batch on one device, or on one rank's device
    of a mesh.

    Args:
        ctrees: One initial ``ContractionTree`` per replica (same shape).
        seeds: One integer seed per replica (initial slices and the
            batch's ``torch.Generator``).
        cmodel: Finite-width cost model (``max_width``); a sparse one
            caps every cost's and width's sparse part at
            ``log2(n_projs)`` ('walker' refuses it, as the JAX walker
            does; 'walks' then takes the reference slicer).
        mesh: as in :class:`ReplicaRunner`.
        engine: 'auto', 'batched', 'vmapped', 'walks', 'walker',
            'multiwalk', 'sweep' or 'native'.  'auto' resolves by the JAX
            runner's rule (``replicas.py:689-708``: 'batched' for N*W <=
            32768 without new slices, else 'walks' on the card for a
            dense model without new slices, else 'native' where
            :func:`_native_available` and the model is dense, else
            'vmapped'), which never picks 'walker' or 'sweep'.  'vmapped'
            keeps replica-major :class:`~tnco_tpu_torch.kernels.
            sa_finite.SAStateFW` states and runs the lockstep sweep on
            them.  'sweep' runs :func:`~tnco_tpu_torch.kernels.
            sa_fullsweep.run_fullsweep_fw`.  'native' runs
            :func:`tnco_tpu_torch.native.sa_run_fw` on host numpy trees
            and slices.
        max_number_new_slices: Slices a rejected move may add to fit the
            cap (the rescue; not on 'walks', 'walker', 'multiwalk' and
            'sweep', as in the JAX runner).
        prob_kind: None means 'mh_local' on 'sweep', else 'mh';
            'mh_local' runs on 'sweep' and 'walks' only.
        n_walks: Walks per replica (default 128 for 'walks', 8 for
            'walker' and 'multiwalk').
        walk_chunk: as in :class:`ReplicaRunner` ('multiwalk').
        on_block, accept_rule: 'walks' and 'multiwalk' options ('walker'
            takes only 'advance' and 'round').
        dtype: as in :class:`ReplicaRunner` (the walker refuses float64).
        device: ``None`` means ``'cuda'``; pass ``'cpu'`` explicitly.
    """

    def __init__(self,
                 ctrees,
                 seeds,
                 *,
                 cmodel,
                 skip_slices_lanes=None,
                 disable_shared_inds: bool = False,
                 prob_kind: str | None = None,
                 max_number_new_slices: int = 0,
                 mesh=None,
                 engine: str = 'auto',
                 n_walks: int | None = None,
                 walk_chunk: int = 0,
                 on_block: str | None = None,
                 accept_rule: str | None = None,
                 fw_slicer: str | None = None,
                 dtype=torch.float32,
                 device=None) -> None:
        _check_meshless(engine, mesh)
        self.device = _runner_device(device, mesh)
        ctrees = list(ctrees)
        seeds = [int(s) for s in seeds]
        if len(ctrees) != len(seeds) or not ctrees:
            raise ValueError("One seed per replica is required.")
        shapes = {(len(c), c.inds_array.shape[1]) for c in ctrees}
        if len(shapes) != 1:
            raise ValueError("All replicas must share the tree shape.")

        self.fw_slicer = fw_slicer
        self.template = ctrees[0]
        n_lanes = self.template.inds_array.shape[1]
        self.sparse_lanes, self.sparse_wb, self.log2_n_projs = \
            _sparse_params(cmodel, self.template, self.device)
        self.log2d = bitops.pad_log2_dims(self.template.log2_dims_array,
                                          n_lanes, dtype, self.device)
        self.max_width = torch.tensor(cmodel.max_width, dtype=dtype,
                                      device=self.device)
        skip = (np.zeros(n_lanes, dtype=np.uint32)
                if skip_slices_lanes is None else
                np.asarray(skip_slices_lanes, dtype=np.uint32))
        self.skip_lanes = torch.from_numpy(skip.view(np.int32)).to(
            self.device)

        if engine == 'auto':
            engine = resolve_engine(
                len(self.template), n_lanes,
                accel=_accel_available(self.device),
                native=_native_available(),
                sparse=self.sparse_lanes is not None,
                max_new_slices=int(max_number_new_slices),
                disable_shared_inds=disable_shared_inds,
                prob_kind=prob_kind)
        if engine not in _ENGINES:
            raise ValueError(f"Unknown engine: {engine!r}")
        if engine == 'walker':
            kwalker.dense_only(self.sparse_wb)
            kwalker.float32_only(dtype)
        if max_number_new_slices and engine in ('multiwalk', 'walker',
                                                'sweep', 'walks'):
            raise ValueError(f"engine={engine!r} does not support "
                             "max_number_new_slices.")
        prob_kind = _resolve_prob_kind(prob_kind, engine)
        if engine == 'walker' and not kwalker.walker_supported_fw(
                len(self.template), self.template.n_leaves, n_lanes):
            raise ValueError(
                f"engine='walker' does not run on N={len(self.template)}, "
                f"W={n_lanes} (kernels.walker.walker_supported_fw).")
        self.cfg = SweepConfigFW(n_leaves=self.template.n_leaves,
                                 n_lanes=n_lanes,
                                 disable_shared_inds=disable_shared_inds,
                                 prob_kind=prob_kind,
                                 max_new_slices=int(max_number_new_slices))
        self.engine = engine
        self.n_walks = _resolve_walks(engine, n_walks, fw=True)
        self.walk_chunk = int(walk_chunk)
        self.on_block = _resolve_on_block(on_block, engine)
        self.accept_rule = _resolve_accept_rule(accept_rule, engine)
        _check_walk_options(self)
        self.dtype = dtype
        self.mesh = mesh
        self.n_replicas = len(ctrees)
        self.sweeps_done = 0
        self.moves_done = 0
        self.applied_done = None
        self.log2d_w32 = self.log2d.reshape(n_lanes, 32)
        self.uniform_log2 = uniform_log2_dim(self.template.log2_dims_array)
        if engine in ('batched', 'vmapped') and \
                self.uniform_log2 is not None and \
                not float(self.uniform_log2).is_integer():
            # The lockstep engine equals the JAX one bitwise only with
            # popcount widths on integer log2 dims (replicas.py:912-916).
            self.uniform_log2 = None
        lo, hi = _set_block(self, len(ctrees))
        if engine == 'native':
            _init_native(self, ctrees, seeds, fw=True)
            return

        self.states = sfb.init_batch_fw(
            ctrees[lo:hi], seeds[lo:hi], float(self.max_width),
            self.log2d.cpu().numpy(), skip_lanes=skip,
            sparse_lanes=_host_lanes(self.sparse_lanes),
            log2_n_projs=self.log2_n_projs,
            dtype=self.log2d.cpu().numpy().dtype, device=self.device)
        if engine == 'vmapped':
            self.states = saf.from_batch_fw(self.states)
        _init_draws(self, seeds)

    def run(self,
            betas,
            *,
            update_slices: int = 10,
            chunk_size: int = 128,
            timeout: float | None = None,
            callback=None,
            exchange_every: int = 0,
            exchange_fraction: float = 0.25,
            exchange_islands: int = 1,
            exchange_axes=None) -> dict:
        """Anneals over ``betas`` (``[n]`` or per lane ``[n, B]``, not on
        'walker' or 'native') in chunks of ``chunk_size`` steps (sweeps
        for 'batched'; the last chunk padded with its last beta and no
        reslice, as in the JAX runner), drawing from the batch's
        generator.  The reslice mask is global (``step % update_slices ==
        0``), cut per chunk; 'native' reslices every ``update_slices``
        sweeps of a chunk.  'batched' and 'vmapped' count no applied
        moves.  Exchange as in :meth:`ReplicaRunner.run`, with
        :func:`exchange_best_fw` (on a mesh :func:`exchange_best_fw_
        sharded`; the slice set travels with the tree)."""
        if exchange_every and self.engine not in _LANE_MAJOR:
            _warn_exchange(self.engine)
        if self.engine == 'native':
            return _run_native(self, betas, chunk_size, timeout, callback,
                               update_slices)
        betas = _local_betas(self, betas)
        n = len(betas)
        mask = ((np.arange(n) % max(1, update_slices)) == 0
                if update_slices else np.zeros(n, dtype=bool))
        start = time.perf_counter()
        pos = 0
        n_chunks = 0
        chunk_size = max(1, min(chunk_size, n))
        while pos < n:
            if _out_of_time(self, start, timeout):
                break
            with span('tnco.runner.chunk', n_chunks):
                chunk = betas[pos:pos + chunk_size]
                mchunk = mask[pos:pos + chunk_size]
                if len(chunk) < chunk_size:
                    pad = chunk_size - len(chunk)
                    chunk = np.concatenate(
                        [chunk, np.repeat(chunk[-1:], pad, axis=0)])
                    mchunk = np.concatenate(
                        [mchunk, np.zeros(pad, dtype=bool)])
                sp = (self.sparse_wb, self.log2_n_projs)
                gen = self._draws
                if self.engine == 'batched':
                    self.states, metrics = sfb.run_sweeps_fw_batched(
                        self.states, chunk, mchunk, self.max_width,
                        self.log2d_w32, self.skip_lanes, self.cfg, *sp,
                        uniform_log2=self.uniform_log2, generator=gen)
                elif self.engine == 'vmapped':
                    self.states, metrics = saf.run_sweeps_fw_batch(
                        self.states, chunk, mchunk, self.max_width,
                        self.log2d, self.skip_lanes, self.cfg,
                        self.sparse_lanes, self.log2_n_projs,
                        uniform_log2=self.uniform_log2, generator=gen)
                elif self.engine == 'walks':
                    self.states, metrics = swk.run_walks_fw(
                        self.states, chunk, mchunk, self.max_width,
                        self.log2d_w32, self.skip_lanes, self.cfg,
                        self._mw_pos, *sp, uniform_log2=self.uniform_log2,
                        on_block=self.on_block, accept_rule=self.accept_rule,
                        slicer=self.fw_slicer, generator=gen,
                        device=self.device)
                elif self.engine == 'sweep':
                    self.states, metrics = sfs.run_fullsweep_fw(
                        self.states, chunk, mchunk, self.max_width,
                        self.log2d_w32, self.skip_lanes, self.cfg, *sp,
                        uniform_log2=self.uniform_log2, generator=gen)
                elif self.engine == 'walker':
                    self.states, metrics = kwalker.run_walker_fw(
                        self.states, chunk, mchunk, self.max_width,
                        self.log2d_w32, self.skip_lanes, self.cfg,
                        self.n_walks, self._mw_pos,
                        uniform_log2=self.uniform_log2, generator=gen)
                else:
                    self.states, metrics = smw.run_multiwalk_fw(
                        self.states, chunk, mchunk, self.max_width,
                        self.log2d_w32, self.skip_lanes, self.cfg,
                        self.n_walks, self._mw_pos, *sp,
                        uniform_log2=self.uniform_log2,
                        on_block=self.on_block, accept_rule=self.accept_rule,
                        walk_chunk=self.walk_chunk, generator=gen)
                self._count(metrics, chunk_size)
            pos += chunk_size
            n_chunks += 1
            if (exchange_every and self.engine in _LANE_MAJOR and pos < n
                    and n_chunks % exchange_every == 0):
                if self.mesh is not None:
                    self.states = exchange_best_fw_sharded(
                        self.states, self.mesh, exchange_axes,
                        exchange_fraction)
                else:
                    self.states = exchange_best_fw(
                        self.states, exchange_fraction, exchange_islands)
            if callback is not None:
                callback({
                    'progress': min(pos, n) / n,
                    'log2_min_total': self.log2_min_totals(),
                })
        return {
            'log2_min_total': self.log2_min_totals(),
            'sweeps': self.sweeps_done,
            'moves': self.moves_done,
            'applied': self.applied_done,
            'runtime_s': time.perf_counter() - start,
        }

    _count = ReplicaRunner._count
    _replica = ReplicaRunner._replica
    _tree = ReplicaRunner._tree
    min_ctree = ReplicaRunner.min_ctree
    ctree = ReplicaRunner.ctree
    log2_min_totals = ReplicaRunner.log2_min_totals

    def slices_lanes(self, replica: int) -> np.ndarray:
        """Current slice lanes of ``replica`` (``uint32 [W]``; a
        collective on a mesh)."""
        if self.engine == 'native':
            return self._nat_slices[replica].copy()
        (lanes,) = self._replica(('slices',), replica)
        return lanes.cpu().numpy().view(np.uint32)

    def min_slices_lanes(self, replica: int) -> np.ndarray:
        """Slice lanes of ``replica``'s best tree (a collective on a
        mesh)."""
        if self.engine == 'native':
            return self._nat_best_slices[replica].copy()
        (lanes,) = self._replica(('min_slices',), replica)
        return lanes.cpu().numpy().view(np.uint32)


def _island_exchange_plan(lt, fraction: float, islands: int, active):
    """Worst lanes and sources of the exchange (``replicas.py:1086``).

    The replica axis splits into ``islands`` equal contiguous groups; in
    each, the lanes at or above the ``(bg - k)``-th sorted total (``k =
    max(1, int(bg * fraction))``) and strictly worse than the group's
    best are the worst, so lanes tied with the best keep their trees.
    ``active`` (``bool[G]``, optional) gates exchange per island.  Returns
    ``(worst_mask [B], src_idx [G], best_val [G, 1])``; ``argmin`` takes
    the first lane on ties, as ``jnp.argmin`` does.
    """
    b = lt.shape[0]
    g = max(1, int(islands))
    if b % g:
        raise ValueError(f"islands={g} must divide the replica count {b}.")
    bg = b // g
    k = max(1, int(bg * fraction))
    lt2 = lt.reshape(g, bg)
    best = torch.argmin(lt2, dim=1)                              # [G]
    best_val = torch.take_along_dim(lt2, best[:, None], dim=1)   # [G, 1]
    thresh = torch.sort(lt2, dim=1).values[:, bg - k]
    worst2 = (lt2 >= thresh[:, None]) & (lt2 > best_val)
    if active is not None:
        worst2 = worst2 & torch.as_tensor(
            np.asarray(active, dtype=bool), device=lt.device).reshape(g, 1)
    return worst2.reshape(b), best, best_val


def _island_mix(cur, worst, best, g):
    """Copies each island's best lane into its worst lanes (replica axis
    LAST)."""
    b = cur.shape[-1]
    lead = tuple(cur.shape[:-1])
    cur2 = cur.reshape(lead + (g, b // g))
    idx = best.reshape((1,) * len(lead) + (g, 1))
    src = torch.take_along_dim(cur2, idx.expand(lead + (g, 1)), dim=-1)
    mask = worst.reshape((1,) * len(lead) + (g, b // g))
    return torch.where(mask, src, cur2).reshape(cur.shape)


def _exchange(states, fraction, islands, active, names):
    lt = states.log2_total
    g = max(1, int(islands))
    worst, best, best_val = _island_exchange_plan(lt, fraction, g, active)
    lt_best = best_val.expand(g, lt.shape[0] // g).reshape(-1)
    mixed = {k: _island_mix(getattr(states, k), worst, best, g)
             for k in names}
    return dataclasses.replace(states, log2_total=torch.where(
        worst, lt_best, lt), **mixed)


def exchange_best(states: sb.SABatch, fraction: float = 0.25,
                  islands: int = 1, active=None) -> sb.SABatch:
    """Population exchange (``replicas.py:1137``): the worst ``fraction``
    of each island's lanes (by current total) restart from the island
    best's current tree (``c0, c1, par, inds, hyper, lcc`` and the
    total).  Min snapshots and ``keys`` are untouched; walk positions
    live in the runner and stay as they are.  ``islands``/``active``: see
    :func:`_island_exchange_plan`.  Returns a new batch."""
    return _exchange(states, fraction, islands, active,
                     ('c0', 'c1', 'par', 'inds', 'hyper', 'lcc'))


def exchange_best_fw(states: sfb.SABatchFW, fraction: float = 0.25,
                     islands: int = 1, active=None) -> sfb.SABatchFW:
    """Finite-width population exchange (``replicas.py:1247``): as
    :func:`exchange_best`, with the pre-slicing widths and the slice set
    travelling with the tree."""
    return _exchange(states, fraction, islands, active,
                     ('c0', 'c1', 'par', 'inds', 'hyper', 'lcc', 'width',
                      'slices'))


def _exchange_sharded(states, mesh, axis_names, fraction, names):
    """The sharded exchange (``replicas.py:1166-1244``) on this rank's
    block ``states``: the group of ranks over ``axis_names`` (default:
    all mesh axes) finds its best current total with an all-reduce MIN;
    its owner is the lowest row-major rank index over those axes among
    the ranks that hold it; the owner's best lane (``names``) reaches the
    group as a masked sum of its words.  Then the rank restarts its local
    lanes at or above the ``(b - k)``-th sorted total, ``k = max(1, int(b
    * fraction))``, that are strictly worse than the group's best.  Min
    snapshots and ``keys`` are untouched.  Every rank of the mesh calls
    it."""
    group, lin, _ = tmesh.axes_group(mesh, axis_names)
    lt = states.log2_total
    li = int(torch.argmin(lt))
    local_min = lt[li:li + 1]
    group_min = tmesh.all_reduce(local_min, 'min', group)
    holds = bool(local_min == group_min)
    cand = torch.tensor([lin if holds else 2**30], dtype=torch.int64,
                        device=lt.device)
    owner = int(tmesh.all_reduce(cand, 'min', group))
    cols = tmesh.owner_rows([getattr(states, k)[..., li] for k in names],
                            holds and lin == owner, group)
    b = lt.shape[0]
    k = max(1, int(b * fraction))
    thresh = torch.sort(lt).values[b - k]
    worst = (lt >= thresh) & (lt > group_min)
    mixed = {name: torch.where(worst, col[..., None], getattr(states, name))
             for name, col in zip(names, cols)}
    return dataclasses.replace(
        states, log2_total=torch.where(worst, group_min, lt), **mixed)


def exchange_best_sharded(states: sb.SABatch, mesh, axis_names=None,
                          fraction: float = 0.25) -> sb.SABatch:
    """Mesh-aware population exchange (``replicas.py:1166``): within each
    group of ranks spanned by ``axis_names`` (default: all mesh axes; e.g.
    ``('ici',)`` of a ``('dcn', 'ici')`` mesh keeps it off the 'dcn'
    axis), the group's best current tree replaces the worst ``fraction``
    of each rank's local lanes (see :func:`_exchange_sharded`).
    ``states`` is this rank's block; every rank calls it."""
    return _exchange_sharded(states, mesh, axis_names, fraction,
                             ('c0', 'c1', 'par', 'inds', 'hyper', 'lcc'))


def exchange_best_fw_sharded(states: sfb.SABatchFW, mesh, axis_names=None,
                             fraction: float = 0.25) -> sfb.SABatchFW:
    """Mesh-aware finite-width exchange (``replicas.py:1273``): as
    :func:`exchange_best_sharded`, with the pre-slicing widths and the
    slice set travelling with the tree."""
    return _exchange_sharded(states, mesh, axis_names, fraction,
                             ('c0', 'c1', 'par', 'inds', 'hyper', 'lcc',
                              'width', 'slices'))


def _kick_keys(seed: int, lanes) -> np.ndarray:
    """The victims' seed words ``[0, (seed * 2654435761 + 7919 * lane) &
    0xFFFFFFFF]`` (the ``init_batch_fw`` layout), ``int32 [K, 2]``."""
    words = np.asarray([(seed * 2654435761 + 7919 * int(lane)) & 0xFFFFFFFF
                        for lane in lanes], dtype=np.uint32)
    return np.stack([np.zeros_like(words), words], axis=1).view(np.int32)


def _kick_cols_host(runner, src: int, lanes, seed: int):
    """Host half of the slice-kick (``replicas.py:1484-1544``): one fresh
    greedy slice set of ``src``'s tree per victim (``random.Random((seed
    * 1000003 + lane) & 0x7FFFFFFF)`` jitter) and its float64 slice-aware
    ``lcc`` and total, the sparse part capped under a sparse cost model.
    Returns ``(slices uint32 [W, K], lcc float64 [N, K], lt float64
    [K])``."""
    s = runner.states
    inds_src = s.inds[..., src].cpu().numpy().view(np.uint32)   # [N, W]
    c0_src = s.c0[:, src].cpu().numpy()
    c1_src = s.c1[:, src].cpu().numpy()
    n, w = inds_src.shape
    log2d = runner.log2d.cpu().numpy().astype(np.float64)       # [w*32]
    mw = float(runner.max_width)
    shifts = np.arange(32, dtype=np.uint32)

    def expand(lanes_u32):  # [..., w] -> bool [..., w*32]
        bits = (lanes_u32[..., :, None] >> shifts) & 1
        return bits.astype(bool).reshape(*lanes_u32.shape[:-1], w * 32)

    skip_np = runner.skip_lanes.cpu().numpy().view(np.uint32)
    skip_bits = expand(skip_np) if skip_np.any() else None
    log2_n_projs = runner.log2_n_projs
    sparse_bits = (None if runner.sparse_lanes is None else
                   expand(_host_lanes(runner.sparse_lanes)))

    def width_of(bits):
        if sparse_bits is None:
            return bits @ log2d
        return ((bits & ~sparse_bits) @ log2d +
                np.minimum((bits & sparse_bits) @ log2d,
                           float(log2_n_projs)))

    k = len(lanes)
    new_slices = np.empty((w, k), dtype=np.uint32)
    for j, lane in enumerate(lanes):
        new_slices[:, j] = greedy_slices_host(
            inds_src, log2d, mw,
            Random((seed * 1000003 + int(lane)) & 0x7FFFFFFF),
            skip_bits=skip_bits, sparse_bits=sparse_bits,
            log2_n_projs=log2_n_projs)

    internal = c0_src >= 0
    inds_c0 = np.take_along_axis(
        inds_src, np.where(internal, c0_src, 0)[:, None], axis=0)
    inds_c1 = np.take_along_axis(
        inds_src, np.where(internal, c1_src, 0)[:, None], axis=0)
    n_leaves = runner.template.n_leaves
    new_lcc = np.empty((n, k), dtype=np.float64)
    new_lt = np.empty(k, dtype=np.float64)
    for j in range(k):
        union = expand(inds_c0 | inds_c1 | new_slices[None, :, j])
        lcc_j = np.where(internal, width_of(union), -np.inf)
        new_lcc[:, j] = lcc_j
        tail = lcc_j[n_leaves:]
        if tail.size:
            m = tail.max()
            new_lt[j] = m + np.log2(np.exp2(tail - m).sum())
        else:
            new_lt[j] = -np.inf
    return new_slices, new_lcc, new_lt


def _kick_cols_device(runner, src: int, k: int, jitter):
    """Device half of the slice-kick (``_kick_cols_fw``,
    ``replicas.py:1350``), for the ``k`` victims' columns only: the
    device slicer (:func:`sfb._greedy_slices_b`, which reaches K1 through
    the plane slicer on uniform integer dims) on ``src``'s tree broadcast
    over ``k`` columns, one jitter column each, then the slice-aware
    ``lcc`` (:func:`sfb._lcc_fw_b`) and its pinned total.  (The JAX
    package computed all ``B`` columns to keep one compiled shape; each
    column is independent of the others, so the victims' columns are the
    same values.)  Returns ``(slices [W, k], lcc [N, k], lt [k])``."""
    s = runner.states
    n, w = s.inds.shape[:2]
    inds_k = s.inds[..., src:src + 1].expand(n, w, k)
    c0_k = s.c0[:, src:src + 1].expand(n, k)
    c1_k = s.c1[:, src:src + 1].expand(n, k)
    width_k = s.width[:, src:src + 1].expand(n, k)
    ul = uniform_log2_dim(runner.template.log2_dims_array)
    sp = (runner.sparse_wb, runner.log2_n_projs)
    slices = sfb._greedy_slices_b(c0_k, inds_k, width_k, jitter,
                                  runner.max_width, runner.log2d_w32,
                                  runner.skip_lanes, *sp, uniform_log2=ul)
    lcc = sfb._lcc_fw_b(c0_k, c1_k, inds_k, slices, runner.log2d_w32, *sp,
                        uniform_log2=ul)
    lt = costs_ops.log2_total_from_lcc(lcc, runner.template.n_leaves)
    return slices, lcc, lt


def kick_lanes_fw(runner: ReplicaRunnerFW, lanes, src: int, seed: int, *,
                  slicer: str = 'device', jitter=None) -> None:
    """Slice-kick (``replicas.py:1398``): restart ``lanes`` from ``src``'s
    current tree with FORCED fresh slice sets and fresh seed words.

    Each victim takes ``src``'s ``c0, c1, par, inds, hyper, width``, an
    UNGATED fresh greedy slice set, its slice-aware ``lcc`` and total,
    the ``keys`` ``[0, (seed * 2654435761 + 7919 * lane) & 0xFFFFFFFF]``
    and a restarted walk position (-1).  Non-victims and every min
    snapshot stay bitwise as they were, so the reported best never
    regresses.  Updates ``runner.states`` and ``runner._mw_pos``.

    ``slicer='device'`` runs the device slicer on the victims' columns
    (:func:`_kick_cols_device`) with ``jitter [n_bits, K]`` for the
    ``K`` sorted victims, drawn from ``runner.generator`` unless given;
    ``'host'`` is the per-victim host slicer with the JAX package's
    ``random.Random`` streams and float64 costs (bitwise its values).
    Drive it from :class:`tnco_tpu_torch.parallel.stall.
    IslandStallKicker`.  One-device runners only (the JAX package's
    "single-mesh runners only").
    """
    if runner.engine not in _LANE_MAJOR or runner.states is None:
        raise ValueError("kick_lanes_fw needs a lane-major device engine "
                         f"(engine={runner.engine!r}).")
    if runner.mesh is not None:
        raise ValueError("kick_lanes_fw runs on one-device runners; this "
                         "runner holds one rank's block of a mesh.")
    if slicer not in ('device', 'host'):
        raise ValueError(f"slicer must be 'device' or 'host', got "
                         f"{slicer!r}.")
    s = runner.states
    b = int(s.log2_total.shape[0])
    lanes = np.asarray(sorted(set(int(x) for x in lanes)), dtype=np.int64)
    if lanes.size == 0:
        return
    dev = s.c0.device
    src = int(src)
    k = lanes.size
    lanes_t = torch.from_numpy(lanes).to(dev)
    mask = torch.zeros(b, dtype=torch.bool, device=dev)
    mask[lanes_t] = True

    if slicer == 'device':
        n_bits = runner.log2d_w32.numel()
        if jitter is None:
            jitter = torch.rand((n_bits, k), generator=runner.generator,
                                device=dev, dtype=s.lcc.dtype)
        elif tuple(jitter.shape) != (n_bits, k):
            raise ValueError(f"jitter must be [{n_bits}, {k}], got "
                             f"{tuple(jitter.shape)}.")
        slices, lcc, lt = _kick_cols_device(runner, src, k,
                                            jitter.to(dev, s.lcc.dtype))
    else:
        slices, lcc, lt = (torch.from_numpy(x) for x in
                           _kick_cols_host(runner, src, lanes, seed))
        slices = slices.view(torch.int32)

    def mix(cur):
        m = mask.reshape((1,) * (cur.ndim - 1) + (b,))
        return torch.where(m, cur[..., src:src + 1], cur)

    def put(cur, new):
        out = cur.clone()
        out[..., lanes_t] = new.to(dev, cur.dtype)
        return out

    keys = s.keys.clone()
    keys[lanes_t] = torch.from_numpy(_kick_keys(seed, lanes)).to(dev)
    runner.states = dataclasses.replace(
        s, c0=mix(s.c0), c1=mix(s.c1), par=mix(s.par), inds=mix(s.inds),
        hyper=mix(s.hyper), width=mix(s.width), lcc=put(s.lcc, lcc),
        slices=put(s.slices, slices), log2_total=put(s.log2_total, lt),
        keys=keys)
    runner._mw_pos = torch.where(mask[None, :], -1, runner._mw_pos)

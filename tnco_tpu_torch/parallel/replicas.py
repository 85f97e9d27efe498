"""Replica runners (the port of ``tnco_tpu/parallel/replicas.py``):
:class:`ReplicaRunner` (infinite memory, engines 'batched', 'vmapped',
'walks', 'walker', 'multiwalk' and 'sweep') and :class:`ReplicaRunnerFW`
(finite width, the same engines), and
the population operators that run between chunks: island exchange
(:func:`exchange_best`, :func:`exchange_best_fw`) and the slice-kick
(:func:`kick_lanes_fw`).  Both runners take a sparse cost model (every
engine but 'walker', which refuses it as the JAX walker does).

Replicas of one connected component share array shapes, so a batch is
one stacked state on one device; ``run`` anneals it in chunks with a
wall-clock budget and host callbacks (and, finite width, re-derives the
slice set every ``update_slices`` steps, reference finite_width/sa.py:
228).
"""

import dataclasses
from random import Random
import time
from warnings import warn

import numpy as np
import torch

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
from tnco_tpu_torch.ops import bitops
from tnco_tpu_torch.ops import costs as costs_ops

__all__ = ['ReplicaRunner', 'ReplicaRunnerFW', 'exchange_best',
           'exchange_best_fw', 'kick_lanes_fw']

_ENGINES = ('batched', 'vmapped', 'native', 'multiwalk', 'walker', 'sweep',
            'walks')
_PORTED = ('batched', 'vmapped', 'walks', 'walker', 'multiwalk', 'sweep')
# Engines whose state keeps the replica axis last; exchange and the kick
# run on them only ('vmapped' keeps replica-major states), as in the JAX
# runners.
_LANE_MAJOR = ('batched', 'walks', 'walker', 'multiwalk', 'sweep')
# ROADMAP queue 1 items of the engines that are not ported yet.
_ITEMS = {'native': 'item 10'}
# The engines that take the walk options (on_block, accept_rule).
_WALK_ENGINES = ('multiwalk', 'walks')


def _accel_available(device: torch.device) -> bool:
    """True when the runner's device is the card (the 'auto' rule's
    "accelerator present"; tests monkeypatch it to pin the routing)."""
    return device.type == 'cuda'


def _native_available() -> bool:
    """The port has no native C++ engine yet (ROADMAP queue 1, item 10)."""
    return False


def resolve_engine(n_nodes: int, n_lanes: int, *, accel: bool,
                   native: bool, sparse: bool, max_new_slices: int,
                   disable_shared_inds: bool, prob_kind,
                   fw: bool = True) -> str:
    """The JAX runners' 'auto' rule (``replicas.py:689-708`` finite
    width, ``:282-301`` infinite memory with ``fw=False``): small states
    go to 'batched', large dense ones on a device to 'walks' (FW) or
    'walker' (IM), the rest (sparse indices, new slices, other accept
    rules) to 'vmapped'."""
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


def _check_exchange_axes(exchange_axes) -> None:
    if exchange_axes is not None:
        raise NotImplementedError(
            "exchange_axes names mesh axes; multi-device runs are not "
            "ported yet (ROADMAP queue 1, item 15).")


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
    """Infinite-memory replica batch on one device.

    Args:
        ctrees: One initial ``ContractionTree`` per replica (same shape).
        seeds: One integer seed per replica (the batch's
            ``torch.Generator`` is seeded from all of them).
        cmodel: Infinite-memory cost model; a sparse one caps every
            cost's sparse part at ``log2(n_projs)`` ('walker' refuses it,
            as the JAX walker does).
        disable_shared_inds, prob_kind: Kernel flags; ``prob_kind`` None
            means 'mh_local' on 'sweep', else 'mh'; 'mh_local' runs on
            'sweep' and 'walks' only.
        engine: 'auto', 'batched', 'vmapped', 'walks', 'walker',
            'multiwalk' or 'sweep'.  'auto' resolves by the JAX runner's rule
            (``replicas.py:282-301``: 'batched' for N*W <= 32768, else
            'walker' on the card for a dense model, else 'vmapped'); an
            engine that is not ported yet raises, naming its ROADMAP
            item.  'vmapped' keeps replica-major :class:`~tnco_tpu_torch.
            kernels.sa_infinite.SAStateIM` states and runs the lockstep
            sweep on them (equal to 'batched' on the same draws).
            'walks' runs :func:`~tnco_tpu_torch.kernels.sa_walks.
            run_walks` (rows through K1 and K3); 'sweep' runs
            :func:`~tnco_tpu_torch.kernels.sa_fullsweep.run_fullsweep`
            (a proposal at every node a round, rows through K1; 'auto'
            never picks it).
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
        self.device = resolve_device(device)
        ctrees = list(ctrees)
        seeds = [int(s) for s in seeds]
        if len(ctrees) != len(seeds):
            raise ValueError("One seed per replica is required.")
        if not ctrees:
            raise ValueError("'ctrees' cannot be empty.")
        shapes = {(len(c), c.inds_array.shape[1]) for c in ctrees}
        if len(shapes) != 1:
            raise ValueError("All replicas must share the tree shape.")
        if mesh is not None:
            raise NotImplementedError(
                "Multi-device runs are not ported yet (ROADMAP queue 1, "
                "item 15).")

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
        if engine not in _PORTED:
            raise NotImplementedError(
                f"engine={engine!r} is not ported to tnco_tpu_torch yet "
                f"(ROADMAP queue 1, {_ITEMS[engine]}); pass "
                f"one of {_PORTED}.")
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
        self.log2d = bitops.pad_log2_dims(self.template.log2_dims_array,
                                          n_lanes, dtype, self.device)
        self.log2d_w32 = self.log2d.reshape(n_lanes, 32)
        self.uniform_log2 = uniform_log2_dim(self.template.log2_dims_array)

        self.states = sb.init_batch(
            ctrees, seeds, self.log2d.cpu().numpy(),
            sparse_lanes=_host_lanes(self.sparse_lanes),
            log2_n_projs=self.log2_n_projs,
            dtype=self.log2d.cpu().numpy().dtype, device=self.device)
        if engine == 'vmapped':
            self.states = sa.from_batch(self.states)
        self._mw_pos = torch.full((self.n_walks, len(ctrees)), -1,
                                  dtype=torch.int32, device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(
            int(np.random.SeedSequence(seeds).generate_state(1)[0]))
        self.n_replicas = len(ctrees)
        self.sweeps_done = 0
        self.moves_done = 0
        self.applied_done = None

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
        not on 'walker', whose kernel reads one beta per iteration).
        After each chunk the host checks the wall-clock budget and calls
        ``callback``.  'batched' and 'vmapped' count no applied moves
        (``applied`` stays None, as in the JAX runner).

        ``exchange_every``: every that many chunks (not after the last),
        :func:`exchange_best` restarts the worst ``exchange_fraction`` of
        each of ``exchange_islands`` islands from its best lane (the
        lane-major engines; 'vmapped' warns and ignores it, as the JAX
        runner does).  ``exchange_axes`` names mesh axes, so it raises
        (one device)."""
        _check_exchange_axes(exchange_axes)
        if exchange_every and self.engine not in _LANE_MAJOR:
            _warn_exchange(self.engine)
        betas = _check_betas(betas, self.n_replicas, self.dtype)
        start = time.perf_counter()
        n = len(betas)
        pos = 0
        n_chunks = 0
        chunk_size = max(1, min(chunk_size, n))
        while pos < n:
            if timeout is not None and time.perf_counter() - start > timeout:
                break
            chunk = betas[pos:pos + chunk_size]
            if len(chunk) < chunk_size:
                chunk = np.concatenate(
                    [chunk,
                     np.repeat(chunk[-1:], chunk_size - len(chunk), axis=0)])
            chunk = torch.from_numpy(chunk).to(self.device)
            sp = (self.sparse_wb, self.log2_n_projs)
            if self.engine == 'batched':
                self.states, metrics = sb.run_sweeps_batched(
                    self.states, chunk, self.log2d_w32, self.cfg, *sp,
                    uniform_log2=self.uniform_log2, generator=self.generator)
            elif self.engine == 'vmapped':
                self.states, metrics = sa.run_sweeps_batch(
                    self.states, chunk, self.log2d, self.cfg,
                    self.sparse_lanes, self.log2_n_projs,
                    uniform_log2=self.uniform_log2, generator=self.generator)
            elif self.engine == 'walker':
                self.states, metrics = kwalker.run_walker(
                    self.states, chunk, self.log2d_w32, self.cfg,
                    self.n_walks, self._mw_pos, generator=self.generator)
            elif self.engine == 'sweep':
                self.states, metrics = sfs.run_fullsweep(
                    self.states, chunk, self.log2d_w32, self.cfg, *sp,
                    uniform_log2=self.uniform_log2, generator=self.generator)
            elif self.engine == 'walks':
                self.states, metrics = swk.run_walks(
                    self.states, chunk, self.log2d_w32, self.cfg,
                    self._mw_pos, *sp, uniform_log2=self.uniform_log2,
                    on_block=self.on_block, accept_rule=self.accept_rule,
                    generator=self.generator, device=self.device)
            else:
                self.states, metrics = smw.run_multiwalk(
                    self.states, chunk, self.log2d_w32, self.cfg,
                    self.n_walks, self._mw_pos, *sp,
                    uniform_log2=self.uniform_log2, on_block=self.on_block,
                    accept_rule=self.accept_rule, walk_chunk=self.walk_chunk,
                    generator=self.generator)
            self._count(metrics, chunk_size)
            pos += chunk_size
            n_chunks += 1
            if (exchange_every and self.engine in _LANE_MAJOR and pos < n
                    and n_chunks % exchange_every == 0):
                self.states = exchange_best(self.states, exchange_fraction,
                                            exchange_islands)
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
        """Adds a chunk's counts (and keeps the walk engines' positions)."""
        self._mw_pos = metrics.get('pos', self._mw_pos)
        self.sweeps_done += chunk_size
        self.moves_done += int(torch.as_tensor(metrics['moves']).sum())
        if 'applied' in metrics:
            self.applied_done = ((self.applied_done or 0) +
                                 int(metrics['applied']))

    def best(self) -> tuple[int, float]:
        """(replica index, log2 cost) of the best replica."""
        mins = self.log2_min_totals()
        idx = int(np.argmin(mins))
        return idx, float(mins[idx])

    def min_ctree(self, replica: int):
        """Best tree found by ``replica`` as a host ``ContractionTree``."""
        s = self.states
        if self.engine == 'vmapped':
            return sa.state_to_ctree(self.template, s.min_nodes[replica],
                                     s.min_inds[replica])
        return _tree_of(self.template, s.min_c0, s.min_c1, s.min_par,
                        s.min_inds, replica)

    def ctree(self, replica: int):
        """Current (not best) tree of ``replica``."""
        s = self.states
        if self.engine == 'vmapped':
            return sa.state_to_ctree(self.template, s.nodes[replica],
                                     s.inds[replica])
        return _tree_of(self.template, s.c0, s.c1, s.par, s.inds, replica)

    def log2_min_totals(self) -> np.ndarray:
        return self.states.min_log2_total.cpu().numpy()


def _host_lanes(lanes):
    """An int32 lane tensor as host ``uint32`` words (None stays None)."""
    return None if lanes is None else \
        lanes.cpu().numpy().view(np.uint32)


def _host(x, replica):
    return np.ascontiguousarray(x[..., replica].cpu().numpy())


def _tree_of(template, c0, c1, par, inds, replica):
    """Replica ``replica`` of replica-minor device arrays as a host
    ``ContractionTree`` (``uint32`` words back from int32 bit patterns)."""
    nodes = np.stack([_host(c0, replica), _host(c1, replica),
                      _host(par, replica)], axis=1)
    return template.replace_arrays(nodes,
                                   _host(inds, replica).view(np.uint32))


class ReplicaRunnerFW:
    """Finite-width replica batch on one device.

    Args:
        ctrees: One initial ``ContractionTree`` per replica (same shape).
        seeds: One integer seed per replica (initial slices and the
            batch's ``torch.Generator``).
        cmodel: Finite-width cost model (``max_width``); a sparse one
            caps every cost's and width's sparse part at
            ``log2(n_projs)`` ('walker' refuses it, as the JAX walker
            does; 'walks' then takes the reference slicer).
        engine: 'auto', 'batched', 'vmapped', 'walks', 'walker',
            'multiwalk' or 'sweep'.  'auto' resolves by the JAX runner's rule
            (``replicas.py:689-708``: 'batched' for N*W <= 32768 without
            new slices, else 'walks' on the card for a dense model
            without new slices, else 'vmapped'), which never picks
            'walker' or 'sweep'; an engine that is not ported yet
            raises, naming its ROADMAP item.  'vmapped' keeps
            replica-major :class:`~tnco_tpu_torch.kernels.sa_finite.
            SAStateFW` states and runs the lockstep sweep on them.
            'sweep' runs :func:`~tnco_tpu_torch.kernels.sa_fullsweep.
            run_fullsweep_fw`.
        max_number_new_slices: Slices a rejected move may add to fit the
            cap (the rescue; 'batched' and 'vmapped' only, as in the JAX
            runner).
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
        self.device = resolve_device(device)
        ctrees = list(ctrees)
        seeds = [int(s) for s in seeds]
        if len(ctrees) != len(seeds) or not ctrees:
            raise ValueError("One seed per replica is required.")
        shapes = {(len(c), c.inds_array.shape[1]) for c in ctrees}
        if len(shapes) != 1:
            raise ValueError("All replicas must share the tree shape.")
        if mesh is not None:
            raise NotImplementedError(
                "Multi-device runs are not ported yet (ROADMAP queue 1, "
                "item 15).")

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
        if engine not in _PORTED:
            raise NotImplementedError(
                f"engine={engine!r} is not ported to tnco_tpu_torch yet "
                f"(ROADMAP queue 1, {_ITEMS[engine]}); pass one of "
                f"{_PORTED}.")
        if engine == 'walker':
            kwalker.dense_only(self.sparse_wb)
            kwalker.float32_only(dtype)
        if max_number_new_slices and engine not in ('batched', 'vmapped'):
            # 'sweep' included (replicas.py:731-734).
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
        self.log2d_w32 = self.log2d.reshape(n_lanes, 32)
        self.uniform_log2 = uniform_log2_dim(self.template.log2_dims_array)
        if engine in ('batched', 'vmapped') and \
                self.uniform_log2 is not None and \
                not float(self.uniform_log2).is_integer():
            # The lockstep engine equals the JAX one bitwise only with
            # popcount widths on integer log2 dims (replicas.py:912-916).
            self.uniform_log2 = None

        self.states = sfb.init_batch_fw(
            ctrees, seeds, float(self.max_width), self.log2d.cpu().numpy(),
            skip_lanes=skip, sparse_lanes=_host_lanes(self.sparse_lanes),
            log2_n_projs=self.log2_n_projs,
            dtype=self.log2d.cpu().numpy().dtype, device=self.device)
        if engine == 'vmapped':
            self.states = saf.from_batch_fw(self.states)
        self._mw_pos = torch.full((self.n_walks, len(ctrees)), -1,
                                  dtype=torch.int32, device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(
            int(np.random.SeedSequence(seeds).generate_state(1)[0]))
        self.n_replicas = len(ctrees)
        self.sweeps_done = 0
        self.moves_done = 0
        self.applied_done = None

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
        'walker') in chunks of ``chunk_size`` steps (sweeps for 'batched';
        the last chunk padded with its last beta and no reslice, as in the
        JAX runner), drawing from the batch's generator.  The reslice mask
        is global (``step % update_slices == 0``), cut per chunk.
        'batched' and 'vmapped' count no applied moves.  Exchange as in
        :meth:`ReplicaRunner.run`, with :func:`exchange_best_fw` (the
        slice set travels with the tree)."""
        _check_exchange_axes(exchange_axes)
        if exchange_every and self.engine not in _LANE_MAJOR:
            _warn_exchange(self.engine)
        betas = _check_betas(betas, self.n_replicas, self.dtype)
        n = len(betas)
        mask = ((np.arange(n) % max(1, update_slices)) == 0
                if update_slices else np.zeros(n, dtype=bool))
        start = time.perf_counter()
        pos = 0
        n_chunks = 0
        chunk_size = max(1, min(chunk_size, n))
        while pos < n:
            if timeout is not None and time.perf_counter() - start > timeout:
                break
            chunk = betas[pos:pos + chunk_size]
            mchunk = mask[pos:pos + chunk_size]
            if len(chunk) < chunk_size:
                pad = chunk_size - len(chunk)
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], pad, axis=0)])
                mchunk = np.concatenate([mchunk, np.zeros(pad, dtype=bool)])
            sp = (self.sparse_wb, self.log2_n_projs)
            if self.engine == 'batched':
                self.states, metrics = sfb.run_sweeps_fw_batched(
                    self.states, chunk, mchunk, self.max_width,
                    self.log2d_w32, self.skip_lanes, self.cfg, *sp,
                    uniform_log2=self.uniform_log2, generator=self.generator)
            elif self.engine == 'vmapped':
                self.states, metrics = saf.run_sweeps_fw_batch(
                    self.states, chunk, mchunk, self.max_width, self.log2d,
                    self.skip_lanes, self.cfg, self.sparse_lanes,
                    self.log2_n_projs, uniform_log2=self.uniform_log2,
                    generator=self.generator)
            elif self.engine == 'walks':
                self.states, metrics = swk.run_walks_fw(
                    self.states, chunk, mchunk, self.max_width,
                    self.log2d_w32, self.skip_lanes, self.cfg, self._mw_pos,
                    *sp, uniform_log2=self.uniform_log2,
                    on_block=self.on_block,
                    accept_rule=self.accept_rule, slicer=self.fw_slicer,
                    generator=self.generator, device=self.device)
            elif self.engine == 'sweep':
                self.states, metrics = sfs.run_fullsweep_fw(
                    self.states, chunk, mchunk, self.max_width,
                    self.log2d_w32, self.skip_lanes, self.cfg, *sp,
                    uniform_log2=self.uniform_log2, generator=self.generator)
            elif self.engine == 'walker':
                self.states, metrics = kwalker.run_walker_fw(
                    self.states, chunk, mchunk, self.max_width,
                    self.log2d_w32, self.skip_lanes, self.cfg, self.n_walks,
                    self._mw_pos, uniform_log2=self.uniform_log2,
                    generator=self.generator)
            else:
                self.states, metrics = smw.run_multiwalk_fw(
                    self.states, chunk, mchunk, self.max_width,
                    self.log2d_w32, self.skip_lanes, self.cfg, self.n_walks,
                    self._mw_pos, *sp, uniform_log2=self.uniform_log2,
                    on_block=self.on_block, accept_rule=self.accept_rule,
                    walk_chunk=self.walk_chunk, generator=self.generator)
            self._count(metrics, chunk_size)
            pos += chunk_size
            n_chunks += 1
            if (exchange_every and self.engine in _LANE_MAJOR and pos < n
                    and n_chunks % exchange_every == 0):
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
    min_ctree = ReplicaRunner.min_ctree
    ctree = ReplicaRunner.ctree

    def _lanes(self, x, replica):
        if self.engine == 'vmapped':
            return x[replica].cpu().numpy().view(np.uint32)
        return _host(x, replica).view(np.uint32)

    def slices_lanes(self, replica: int) -> np.ndarray:
        """Current slice lanes of ``replica`` (``uint32 [W]``)."""
        return self._lanes(self.states.slices, replica)

    def min_slices_lanes(self, replica: int) -> np.ndarray:
        return self._lanes(self.states.min_slices, replica)

    def log2_min_totals(self) -> np.ndarray:
        return self.states.min_log2_total.cpu().numpy()


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
    IslandStallKicker`.
    """
    if runner.engine not in _LANE_MAJOR or runner.states is None:
        raise ValueError("kick_lanes_fw needs a lane-major device engine "
                         f"(engine={runner.engine!r}).")
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

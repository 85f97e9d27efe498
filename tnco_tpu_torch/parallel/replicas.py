"""Replica runners (the port of ``tnco_tpu/parallel/replicas.py``):
:class:`ReplicaRunner` (infinite memory, engines 'batched', 'walker' and
'multiwalk') and :class:`ReplicaRunnerFW` (finite width, engines
'batched', 'walks', 'walker' and 'multiwalk').

Replicas of one connected component share array shapes, so a batch is
one stacked state on one device; ``run`` anneals it in chunks with a
wall-clock budget and host callbacks (and, finite width, re-derives the
slice set every ``update_slices`` steps, reference finite_width/sa.py:
228).
"""

import time

import numpy as np
import torch

from tnco_tpu_torch.device import resolve_device
from tnco_tpu_torch.kernels import sa_batched as sb
from tnco_tpu_torch.kernels import sa_finite_batched as sfb
from tnco_tpu_torch.kernels import sa_multiwalk as smw
from tnco_tpu_torch.kernels import sa_walks as swk
from tnco_tpu_torch.kernels import walker as kwalker
from tnco_tpu_torch.kernels.sa_finite import SweepConfigFW
from tnco_tpu_torch.kernels.sa_fullsweep import uniform_log2_dim
from tnco_tpu_torch.kernels.sa_infinite import SweepConfig
from tnco_tpu_torch.ops import bitops

__all__ = ['ReplicaRunner', 'ReplicaRunnerFW']

_ENGINES = ('batched', 'vmapped', 'native', 'multiwalk', 'walker', 'sweep',
            'walks')
_PORTED = ('batched', 'walks', 'walker', 'multiwalk')
_PORTED_IM = ('batched', 'walker', 'multiwalk')
# ROADMAP queue 1 items of the engines that are not ported yet ('walks'
# only for infinite memory).
_ITEMS = {'vmapped': 'item 12', 'native': 'item 10', 'walks': 'item 10',
          'sweep': 'item 13'}


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
    go to 'batched', large ones on a device to 'walks' (FW) or 'walker'
    (IM)."""
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


class ReplicaRunner:
    """Infinite-memory replica batch on one device.

    Args:
        ctrees: One initial ``ContractionTree`` per replica (same shape).
        seeds: One integer seed per replica (the batch's
            ``torch.Generator`` is seeded from all of them).
        cmodel: Infinite-memory cost model (sparse indices raise).
        disable_shared_inds, prob_kind: Kernel flags; ``prob_kind`` None
            means 'mh'.
        engine: 'auto', 'batched', 'walker' or 'multiwalk'.  'auto'
            resolves by the JAX runner's rule (``replicas.py:282-301``:
            'batched' for N*W <= 32768); an engine that is not ported yet
            raises, naming its ROADMAP item.
        n_walks: Walks per replica (default 8; not used by 'batched').
        on_block, accept_rule: 'multiwalk' options (see
            :func:`~tnco_tpu_torch.kernels.sa_multiwalk.run_multiwalk`).
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
        if cmodel is not None and getattr(cmodel, 'sparse_inds', None):
            raise NotImplementedError(
                "Sparse indices are not ported yet (ROADMAP queue 1, left "
                "out of slice 1, e).")

        self.template = ctrees[0]
        n_lanes = self.template.inds_array.shape[1]
        if engine == 'auto':
            engine = resolve_engine(
                len(self.template), n_lanes,
                accel=_accel_available(self.device),
                native=_native_available(), sparse=False, max_new_slices=0,
                disable_shared_inds=disable_shared_inds,
                prob_kind=prob_kind, fw=False)
        if engine not in _ENGINES:
            raise ValueError(f"Unknown engine: {engine!r}")
        if engine not in _PORTED_IM:
            raise NotImplementedError(
                f"engine={engine!r} is not ported to tnco_tpu_torch yet "
                f"(ROADMAP queue 1, {_ITEMS[engine]}); pass "
                "engine='batched', engine='walker' or engine='multiwalk'.")
        if prob_kind is None:
            prob_kind = 'mh'
        on_block = 'advance' if on_block is None else on_block
        accept_rule = 'round' if accept_rule is None else accept_rule
        if engine == 'walker' and not kwalker.walker_supported(
                len(self.template), self.template.n_leaves, n_lanes):
            raise ValueError(
                f"engine='walker' does not run on N={len(self.template)}, "
                f"W={n_lanes} (kernels.walker.walker_supported).")
        if engine in ('walker', 'batched') and (on_block, accept_rule) != (
                'advance', 'round'):
            raise ValueError(
                "on_block and accept_rule other than 'advance' and 'round' "
                "are only supported by the 'multiwalk' and 'walks' "
                f"engines (engine={engine!r}).")
        self.cfg = SweepConfig(n_leaves=self.template.n_leaves,
                               n_lanes=n_lanes,
                               disable_shared_inds=disable_shared_inds,
                               prob_kind=prob_kind)
        smw.check_options(self.cfg, dtype, on_block, accept_rule)
        self.engine = engine
        self.n_walks = _resolve_walks(engine, n_walks)
        self.on_block = on_block
        self.accept_rule = accept_rule
        self.log2d = bitops.pad_log2_dims(self.template.log2_dims_array,
                                          n_lanes, dtype, self.device)
        self.log2d_w32 = self.log2d.reshape(n_lanes, 32)
        self.uniform_log2 = uniform_log2_dim(self.template.log2_dims_array)

        self.states = sb.init_batch(ctrees, seeds, self.log2d.cpu().numpy(),
                                    dtype=np.float32, device=self.device)
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
            exchange_every: int = 0) -> dict:
        """Runs one iteration (a sweep for 'batched') per beta in chunks
        of ``chunk_size`` (the last chunk padded with its last beta, as in
        the JAX runner), drawing the streams from the batch's generator.
        After each chunk the host checks the wall-clock budget and calls
        ``callback``.  'batched' counts no applied moves (``applied``
        stays None, as in the JAX runner).  Island exchange is not ported
        yet."""
        if exchange_every:
            raise NotImplementedError(
                "Island exchange is not ported yet (ROADMAP queue 1, "
                "item 10).")
        betas = np.asarray(betas, dtype=np.float32)
        start = time.perf_counter()
        n = len(betas)
        pos = 0
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
            if self.engine == 'batched':
                self.states, metrics = sb.run_sweeps_batched(
                    self.states, chunk, self.log2d_w32, self.cfg,
                    uniform_log2=self.uniform_log2, generator=self.generator)
            elif self.engine == 'walker':
                self.states, metrics = kwalker.run_walker(
                    self.states, chunk, self.log2d_w32, self.cfg,
                    self.n_walks, self._mw_pos, generator=self.generator)
            else:
                self.states, metrics = smw.run_multiwalk(
                    self.states, chunk, self.log2d_w32, self.cfg,
                    self.n_walks, self._mw_pos,
                    uniform_log2=self.uniform_log2, on_block=self.on_block,
                    accept_rule=self.accept_rule, generator=self.generator)
            self._count(metrics, chunk_size)
            pos += chunk_size
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
        return _tree_of(self.template, s.min_c0, s.min_c1, s.min_par,
                        s.min_inds, replica)

    def ctree(self, replica: int):
        """Current (not best) tree of ``replica``."""
        s = self.states
        return _tree_of(self.template, s.c0, s.c1, s.par, s.inds, replica)

    def log2_min_totals(self) -> np.ndarray:
        return self.states.min_log2_total.cpu().numpy()


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
        cmodel: Finite-width cost model (``max_width``).
        engine: 'auto', 'batched', 'walks', 'walker' or 'multiwalk'.
            'auto' resolves by the JAX runner's rule (``replicas.py:
            689-708``: 'batched' for N*W <= 32768 without new slices),
            which never picks 'walker'; an engine that is not ported yet
            raises, naming its ROADMAP item.
        max_number_new_slices: Slices a rejected move may add to fit the
            cap (the rescue; 'batched' only, as in the JAX runner).
        n_walks: Walks per replica (default 128 for 'walks', 8 for
            'walker' and 'multiwalk').
        on_block, accept_rule: 'walks' and 'multiwalk' options ('walker'
            takes only 'advance' and 'round').
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
        if getattr(cmodel, 'sparse_inds', None):
            raise NotImplementedError(
                "Sparse indices are not ported yet (ROADMAP queue 1, left "
                "out of slice 1, e).")

        self.fw_slicer = fw_slicer
        self.template = ctrees[0]
        n_lanes = self.template.inds_array.shape[1]
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
                native=_native_available(), sparse=False,
                max_new_slices=int(max_number_new_slices),
                disable_shared_inds=disable_shared_inds,
                prob_kind=prob_kind)
        if engine not in _ENGINES:
            raise ValueError(f"Unknown engine: {engine!r}")
        if engine not in _PORTED:
            raise NotImplementedError(
                f"engine={engine!r} is not ported to tnco_tpu_torch yet "
                f"(ROADMAP queue 1, {_ITEMS[engine]}); pass engine='walks', "
                "engine='walker', engine='multiwalk' or engine='batched'.")
        if max_number_new_slices and engine != 'batched':
            raise ValueError(f"engine={engine!r} does not support "
                             "max_number_new_slices.")
        if prob_kind is None:
            prob_kind = 'mh'
        self.on_block = 'advance' if on_block is None else on_block
        self.accept_rule = 'round' if accept_rule is None else accept_rule
        if engine == 'walker' and not kwalker.walker_supported_fw(
                len(self.template), self.template.n_leaves, n_lanes):
            raise ValueError(
                f"engine='walker' does not run on N={len(self.template)}, "
                f"W={n_lanes} (kernels.walker.walker_supported_fw).")
        if engine in ('walker', 'batched') and (
                self.on_block, self.accept_rule) != ('advance', 'round'):
            raise ValueError(
                "on_block and accept_rule other than 'advance' and 'round' "
                "are only supported by the 'multiwalk' and 'walks' "
                f"engines (engine={engine!r}).")
        self.cfg = SweepConfigFW(n_leaves=self.template.n_leaves,
                                 n_lanes=n_lanes,
                                 disable_shared_inds=disable_shared_inds,
                                 prob_kind=prob_kind,
                                 max_new_slices=int(max_number_new_slices))
        if engine != 'walks':
            smw.check_options(self.cfg, dtype, self.on_block,
                              self.accept_rule)
        self.engine = engine
        self.n_walks = _resolve_walks(engine, n_walks, fw=True)
        self.log2d_w32 = self.log2d.reshape(n_lanes, 32)
        self.uniform_log2 = uniform_log2_dim(self.template.log2_dims_array)
        if engine == 'batched' and self.uniform_log2 is not None and \
                not float(self.uniform_log2).is_integer():
            # The lockstep engine equals the JAX one bitwise only with
            # popcount widths on integer log2 dims (replicas.py:912-916).
            self.uniform_log2 = None

        self.states = sfb.init_batch_fw(
            ctrees, seeds, float(self.max_width), self.log2d.cpu().numpy(),
            skip_lanes=skip, dtype=np.float32, device=self.device)
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
            exchange_every: int = 0) -> dict:
        """Anneals over ``betas`` in chunks of ``chunk_size`` steps (sweeps
        for 'batched'; the last chunk padded with its last beta and no
        reslice, as in the JAX runner), drawing from the batch's
        generator.  The reslice mask is global (``step % update_slices ==
        0``), cut per chunk.  'batched' counts no applied moves."""
        if exchange_every:
            raise NotImplementedError(
                "Island exchange is not ported yet (ROADMAP queue 1, "
                "item 7).")
        betas = np.asarray(betas, dtype=np.float32)
        n = len(betas)
        mask = ((np.arange(n) % max(1, update_slices)) == 0
                if update_slices else np.zeros(n, dtype=bool))
        start = time.perf_counter()
        pos = 0
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
            if self.engine == 'batched':
                self.states, metrics = sfb.run_sweeps_fw_batched(
                    self.states, chunk, mchunk, self.max_width,
                    self.log2d_w32, self.skip_lanes, self.cfg,
                    uniform_log2=self.uniform_log2, generator=self.generator)
            elif self.engine == 'walks':
                self.states, metrics = swk.run_walks_fw(
                    self.states, chunk, mchunk, self.max_width,
                    self.log2d_w32, self.skip_lanes, self.cfg, self._mw_pos,
                    uniform_log2=self.uniform_log2, on_block=self.on_block,
                    accept_rule=self.accept_rule, slicer=self.fw_slicer,
                    generator=self.generator, device=self.device)
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
                    self._mw_pos, uniform_log2=self.uniform_log2,
                    on_block=self.on_block, accept_rule=self.accept_rule,
                    generator=self.generator)
            self._count(metrics, chunk_size)
            pos += chunk_size
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

    def min_ctree(self, replica: int):
        s = self.states
        return _tree_of(self.template, s.min_c0, s.min_c1, s.min_par,
                        s.min_inds, replica)

    def ctree(self, replica: int):
        """Current (not best) tree of ``replica``."""
        s = self.states
        return _tree_of(self.template, s.c0, s.c1, s.par, s.inds, replica)

    def slices_lanes(self, replica: int) -> np.ndarray:
        """Current slice lanes of ``replica`` (``uint32 [W]``)."""
        return _host(self.states.slices, replica).view(np.uint32)

    def min_slices_lanes(self, replica: int) -> np.ndarray:
        return _host(self.states.min_slices, replica).view(np.uint32)

    def log2_min_totals(self) -> np.ndarray:
        return self.states.min_log2_total.cpu().numpy()

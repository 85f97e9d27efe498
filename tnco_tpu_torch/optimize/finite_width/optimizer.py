"""Finite-width SA optimizer wrapper (the port of
``tnco_tpu/optimize/finite_width/optimizer.py``).

Label-space front end over the single-replica engine of
:mod:`tnco_tpu_torch.kernels.sa_finite` (one 'vmapped' sweep per update,
plus the reslice-if-better), mirroring the reference wrapper
(tnco/optimize/finite_width/optimizer.py:31-352): ``update(prob,
update_slices=...)``, label-space ``slices``/``min_slices``,
``skip_slices`` (the never-slice set), ``max_number_new_slices`` (the
rescue), exact Decimal costs, ``prng_state``, pickling, and a full
``is_valid`` audit including the post-slicing width bound.
"""

from decimal import Decimal
from typing import Any

import numpy as np
import torch

from tnco_tpu_torch.bitset import Bitset
from tnco_tpu_torch.ctree import ContractionTree
from tnco_tpu_torch.device import resolve_device
from tnco_tpu_torch.kernels import sa_finite as saf
from tnco_tpu_torch.kernels import sa_infinite as sa
from tnco_tpu_torch.ops import bitops
from tnco_tpu_torch.optimize.finite_width.cost_model import SimpleCostModel
from tnco_tpu_torch.optimize.infinite_memory.optimizer import (
    _state_device, engine_ul, generator_to_state, log2_close, resolve_seed)
from tnco_tpu_torch.optimize.prob import BaseProbability

__all__ = ['Optimizer']


class Optimizer:
    """Simulated-annealing optimizer with a maximum tensor width.

    Args:
        ctree: Initial contraction tree.
        cmodel: :class:`SimpleCostModel` (carries ``max_width``).
        max_number_new_slices: Random slices a rejected-for-width move may
            add mid-sweep (0 = slices only change at the reslice step).
        seed / disable_shared_inds / atol / min_ctree / device: as
            infinite memory.  Without ``slices``, the initial slices'
            jitter comes from a generator of its own seeded with the int
            seed (0 for a ``prng_state`` string), so the optimizer's
            stream starts where ``seed`` puts it.
        skip_slices: Labels that must never be sliced.
        slices / min_slices: Resume values (label iterables).
    """

    def __init__(self,
                 ctree: ContractionTree,
                 cmodel: SimpleCostModel,
                 *,
                 max_number_new_slices: int = 0,
                 seed=None,
                 disable_shared_inds: bool = False,
                 atol: float = 1e-5,
                 skip_slices=None,
                 min_ctree: ContractionTree | None = None,
                 slices=None,
                 min_slices=None,
                 device=None) -> None:
        if not isinstance(ctree, ContractionTree):
            raise TypeError("'ctree' must be a ContractionTree.")
        self.device = resolve_device(device)
        self._template = ctree
        self._cmodel = cmodel
        self._atol = float(atol)
        self.disable_shared_inds = bool(disable_shared_inds)
        self.max_number_new_slices = int(max_number_new_slices)

        n_lanes = ctree.inds_array.shape[1]
        self._cfg = saf.SweepConfigFW(
            n_leaves=ctree.n_leaves, n_lanes=n_lanes,
            disable_shared_inds=disable_shared_inds,
            max_new_slices=self.max_number_new_slices)
        dtype = bitops.device_dtype(getattr(cmodel, 'cost_type', 'float64'))
        self._log2d = bitops.pad_log2_dims(ctree.log2_dims_array, n_lanes,
                                           dtype, self.device)
        self._ul = engine_ul(ctree)
        dev = cmodel.device_params(ctree.inds_order)
        self._sparse_lanes = bitops.as_lanes(dev['sparse_lanes'],
                                             self.device)
        self._log2_n_projs = dev['log2_n_projs']

        # skip_slices must leave every tensor sliceable to max_width
        # (reference optimizer.py:96-107).
        self._skip_labels = frozenset(() if skip_slices is None else
                                      skip_slices)
        if not self._skip_labels.issubset(ctree.all_inds()):
            raise ValueError("'skip_slices' has unknown indices.")
        if self._skip_labels:
            dims = ctree.dims
            for xs in ctree.inds:
                if (self._cmodel.width(frozenset(xs) & self._skip_labels,
                                       dims) >
                        self._cmodel.max_width + 1e-6):
                    raise ValueError(
                        "'skip_slices' does not allow fitting "
                        "'max_width'.")
        self._skip_lanes = bitops.as_lanes(
            self._labels_to_lanes(self._skip_labels), self.device)

        self._generator, key_seed = resolve_seed(seed, self.device)
        self._state = self._init(
            ctree, key_seed,
            None if slices is None else self._labels_to_lanes(slices))
        if min_ctree is not None or min_slices is not None:
            min_tree = ctree if min_ctree is None else min_ctree
            min_lanes = (self._state.slices if min_slices is None else
                         self._labels_to_lanes(min_slices))
            m = self._init(min_tree, key_seed, min_lanes)
            s = self._state
            self._state = saf.SAStateFW(
                s.nodes, s.inds, s.hyper, s.lcc, s.width, s.slices,
                s.log2_total, m.log2_total, m.nodes, m.inds, m.slices,
                s.key)

        valid, msg = self.is_valid(atol=atol, return_message=True)
        if not valid:
            raise ValueError(msg)

    def _init(self, ctree, key_seed, slices):
        return saf.init_state_fw(
            ctree, key_seed, self._cmodel.max_width, self._log2d,
            skip_lanes=self._skip_lanes, sparse_lanes=self._sparse_lanes,
            log2_n_projs=self._log2_n_projs, slices=slices,
            dtype=self._log2d.dtype, device=self.device)

    # -- Helpers -------------------------------------------------------------

    def _labels_to_lanes(self, labels) -> np.ndarray:
        order = self._template.inds_order
        positions = [order.index(x) for x in labels]
        return Bitset(positions, n=len(order)).lanes(self._cfg.n_lanes)

    def _lanes_to_labels(self, lanes) -> frozenset:
        order = self._template.inds_order
        words = np.ascontiguousarray(lanes.cpu().numpy()).view(np.uint32)
        b = Bitset.from_lanes(words, len(order))
        return frozenset(order[p] for p in b.positions())

    # -- Optimization ---------------------------------------------------------

    def update(self, prob: BaseProbability, *,
               update_slices: bool = True) -> None:
        """One sweep (+ optional reslice), the reference ``update``
        (greedy/optimizer.hpp:117-390)."""
        self.update_many(prob, [getattr(prob, 'beta', 0.0)],
                         update_slices_every=1 if update_slices else 0,
                         prob_kind=prob.kind)

    def update_many(self, prob, betas, *, update_slices_every: int = 10,
                    prob_kind: str | None = None) -> dict:
        """One sweep per beta, the reslice after sweep ``k`` where ``k %
        update_slices_every == 0``; returns the per-sweep metrics."""
        betas = np.asarray(betas, dtype=np.float64)
        n = betas.shape[0]
        if update_slices_every and update_slices_every > 0:
            mask = (np.arange(n) % update_slices_every) == 0
        else:
            mask = np.zeros(n, dtype=bool)
        cfg = saf.SweepConfigFW(
            n_leaves=self._cfg.n_leaves, n_lanes=self._cfg.n_lanes,
            disable_shared_inds=self.disable_shared_inds,
            prob_kind=prob_kind or prob.kind,
            max_new_slices=self.max_number_new_slices)
        self._state, metrics = saf.run_sweeps_fw(
            self._state, betas, mask, self._cmodel.max_width, self._log2d,
            self._skip_lanes, cfg, self._sparse_lanes, self._log2_n_projs,
            uniform_log2=self._ul, generator=self._generator)
        return {k: v.cpu().numpy() for k, v in metrics.items()}

    # -- Views ----------------------------------------------------------------

    @property
    def ctree(self) -> ContractionTree:
        return sa.state_to_ctree(self._template, self._state.nodes,
                                 self._state.inds)

    @property
    def min_ctree(self) -> ContractionTree:
        return sa.state_to_ctree(self._template, self._state.min_nodes,
                                 self._state.min_inds)

    @property
    def slices(self) -> frozenset:
        return self._lanes_to_labels(self._state.slices)

    @property
    def min_slices(self) -> frozenset:
        return self._lanes_to_labels(self._state.min_slices)

    @property
    def skip_slices(self) -> frozenset:
        return self._skip_labels

    @property
    def cmodel(self) -> SimpleCostModel:
        return self._cmodel

    def _exact_total(self, ctree: ContractionTree, slices) -> int:
        inds = ctree.inds
        return sum(self._cmodel.contraction_cost(
            inds[node.children[0]], inds[node.children[1]], inds[pos],
            ctree.dims, slices) for pos, node in enumerate(ctree.nodes)
            if not node.is_leaf())

    @property
    def total_cost(self) -> Decimal:
        return Decimal(self._exact_total(self.ctree, self.slices))

    @property
    def min_total_cost(self) -> Decimal:
        return Decimal(self._exact_total(self.min_ctree, self.min_slices))

    @property
    def log2_total_cost(self) -> float:
        return float(self._state.log2_total)

    @property
    def log2_min_total_cost(self) -> float:
        return float(self._state.min_log2_total)

    @property
    def prng_state(self) -> str:
        return generator_to_state(self._generator)

    # -- Audit ----------------------------------------------------------------

    def is_valid(self, *, atol: float | None = None,
                 return_message: bool = False):
        """Structure + caches + the post-slicing width bound
        (greedy/optimizer.hpp:392-451)."""
        atol = self._atol if atol is None else float(atol)
        ok, msg = self._is_valid_impl(atol)
        return (ok, msg) if return_message else ok

    def _is_valid_impl(self, atol):
        check = not self.disable_shared_inds
        cur, best = self.ctree, self.min_ctree
        for tree, name in ((cur, 'ctree'), (best, 'min_ctree')):
            ok, msg = tree.is_valid(check_shared_inds=check,
                                    return_message=True)
            if not ok:
                return False, f'{name}: {msg}'

        # Every tensor must fit max_width after slicing.
        dims = cur.dims
        for tree, slices in ((cur, self.slices), (best, self.min_slices)):
            for xs in tree.inds:
                w = self._cmodel.width(frozenset(xs) - slices, dims)
                if w > self._cmodel.max_width + 1e-3:
                    return False, ("Width larger than allowed width after "
                                   "slicing.")

        # Cache audits with the engine's arithmetic.
        s = self._state
        nl = self._cfg.n_leaves
        sp = (self._sparse_lanes, self._log2_n_projs)
        lcc_ref = saf.compute_lcc_fw(s.nodes, s.inds, s.slices, self._log2d,
                                     *sp)
        if not np.allclose(s.lcc[nl:].cpu().numpy(),
                           lcc_ref[nl:].cpu().numpy(), atol=max(atol, 1e-5),
                           rtol=1e-5):
            return False, "CostCache is not properly cached."
        width_ref = saf.compute_widths(s.inds, self._log2d, *sp)
        if not np.allclose(s.width.cpu().numpy(), width_ref.cpu().numpy(),
                           atol=max(atol, 1e-4), rtol=1e-5):
            return False, "WidthCache is not properly cached."
        if not torch.equal(s.hyper, sa.compute_hyper(s.nodes, s.inds)):
            return False, "HyperCache is not properly cached."

        # Min-cost consistency.
        min_state = self._init(best, 0, s.min_slices)
        if not log2_close(float(min_state.log2_total),
                          float(s.min_log2_total), max(atol, 1e-4)):
            return False, "Cost for min ctree is not correct."
        return True, ""

    # -- Pickle ---------------------------------------------------------------

    @classmethod
    def __build__(cls, ctree, cmodel, max_number_new_slices, seed,
                  disable_shared_inds, atol, skip_slices, min_ctree, slices,
                  min_slices):
        return cls(ctree, cmodel,
                   max_number_new_slices=max_number_new_slices, seed=seed,
                   disable_shared_inds=disable_shared_inds, atol=atol,
                   skip_slices=skip_slices, min_ctree=min_ctree,
                   slices=slices, min_slices=min_slices,
                   device=_state_device(seed))

    def __reduce__(self):
        return type(self).__build__, (
            self.ctree, self._cmodel, self.max_number_new_slices,
            self.prng_state, self.disable_shared_inds, self._atol,
            tuple(self._skip_labels) or None, self.min_ctree,
            tuple(self.slices), tuple(self.min_slices))

    def __eq__(self, other: Any) -> bool:
        return (type(self) is type(other) and self.ctree == other.ctree and
                self.min_ctree == other.min_ctree and
                self.slices == other.slices and
                self.min_slices == other.min_slices and
                self._cmodel == other._cmodel and
                self.prng_state == other.prng_state)

    def __repr__(self) -> str:
        return (f'Optimizer(n_nodes={len(self._template)}, '
                f'max_width={self._cmodel.max_width}, '
                f'log2_min_total_cost={self.log2_min_total_cost:.4f})')

"""Infinite-memory SA optimizer wrapper (the port of
``tnco_tpu/optimize/infinite_memory/optimizer.py``).

Label-space, stateful front end over the single-replica engine of
:mod:`tnco_tpu_torch.kernels.sa_infinite` (one 'vmapped' sweep per
update: the lockstep sweep at ``B = 1``, K1 and K3 on the card), with
the reference wrapper's API (tnco/optimize/infinite_memory/
optimizer.py:28-251): ``update(prob)``, ``update_many``, ``min_ctree``,
Decimal ``total_cost``, ``log2_min_total_cost``, ``prng_state``
(resumable), pickling, and a full ``is_valid`` cache audit.

The Decimal costs are exact (Python bigints).  The draws come from one
``torch.Generator`` on the optimizer's device; ``prng_state`` is that
generator's state with its device type (:func:`generator_to_state`),
where the JAX package writes its threefry key.
"""

from decimal import Decimal
import math
import secrets
from typing import Any

import numpy as np
import torch

from tnco_tpu_torch.ctree import ContractionTree
from tnco_tpu_torch.device import resolve_device
from tnco_tpu_torch.kernels import sa_infinite as sa
from tnco_tpu_torch.kernels.sa_fullsweep import uniform_log2_dim
from tnco_tpu_torch.ops import bitops
from tnco_tpu_torch.optimize.infinite_memory.cost_model import \
    SimpleCostModel
from tnco_tpu_torch.optimize.prob import BaseProbability

__all__ = ['Optimizer', 'generator_to_state', 'state_to_generator',
           'resolve_seed', 'log2_close']

_PREFIX = 'torchgen:'


def generator_to_state(generator: torch.Generator) -> str:
    """A generator's state as ``'torchgen:<device type>:<hex>'`` (the
    reference ``prng_state``, optimize/optimizer.hpp:191-195, serialized
    its mt19937 stream)."""
    data = generator.get_state().numpy().tobytes()
    return f'{_PREFIX}{generator.device.type}:{data.hex()}'


def state_to_generator(state: str, device) -> torch.Generator:
    """A generator on ``device`` at the state :func:`generator_to_state`
    wrote.  Raises ``ValueError`` for another string, or for a state of
    another device type (a CPU generator's state does not run a card's
    generator, nor the other way round)."""
    dev = torch.device(device)
    head, _, data = state.partition(':') if state.startswith(_PREFIX) \
        else ('', '', '')
    kind, _, hexdata = data.partition(':')
    if not head or not hexdata:
        raise ValueError("Not a valid PRNG state string.")
    if kind != dev.type:
        raise ValueError(f"The PRNG state was taken on device '{kind}'; "
                         f"this optimizer runs on '{dev.type}'.")
    gen = torch.Generator(device=dev)
    gen.set_state(torch.from_numpy(np.frombuffer(bytes.fromhex(hexdata),
                                                 dtype=np.uint8).copy()))
    return gen


def resolve_seed(seed, device) -> tuple[torch.Generator, int]:
    """``int | state string | None`` -> ``(generator on device, int seed
    for the state's key words)``; None draws a random seed, a state
    string resumes its stream (key words of seed 0)."""
    if isinstance(seed, str):
        return state_to_generator(seed, device), 0
    seed = secrets.randbits(32) if seed is None else int(seed)
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(seed & 0xFFFFFFFFFFFFFFFF)
    return gen, seed


def log2_close(x: float, y: float, atol: float) -> bool:
    """|ln-cost difference| <= atol on log2 values (reference is_logclose,
    include/tnco/utils.hpp:79-87, works on natural logs of linear costs)."""
    if math.isinf(x) or math.isinf(y):
        return x == y
    return abs(x - y) * math.log(2) <= atol


def engine_ul(ctree):
    """The popcount widths' common log2 dim where it is an integer (bitwise
    equal to the pinned tree there, as the 'batched' runners gate it),
    else None."""
    ul = uniform_log2_dim(ctree.log2_dims_array)
    return ul if ul is not None and float(ul).is_integer() else None


class Optimizer:
    """Simulated-annealing optimizer with no memory constraint.

    Args:
        ctree: Initial contraction tree.
        cmodel: :class:`SimpleCostModel`.
        seed: int seed, a ``prng_state`` string, or None (random).
        disable_shared_inds: Allow proposals that break the shared-index
            guarantee.
        atol: Tolerance used by :meth:`is_valid`.
        min_ctree: Optional best-so-far tree to resume from.
        device: ``None`` means ``'cuda'``; pass ``'cpu'`` explicitly.  A
            ``prng_state`` string must come from the same device type.
    """

    def __init__(self,
                 ctree: ContractionTree,
                 cmodel: SimpleCostModel,
                 *,
                 seed=None,
                 disable_shared_inds: bool = False,
                 atol: float = 1e-5,
                 min_ctree: ContractionTree | None = None,
                 device=None) -> None:
        if not isinstance(ctree, ContractionTree):
            raise TypeError("'ctree' must be a ContractionTree.")
        self.device = resolve_device(device)
        self._template = ctree
        self._cmodel = cmodel
        self._atol = float(atol)
        self.disable_shared_inds = bool(disable_shared_inds)

        n_lanes = ctree.inds_array.shape[1]
        self._cfg = sa.SweepConfig(n_leaves=ctree.n_leaves, n_lanes=n_lanes,
                                   disable_shared_inds=disable_shared_inds)
        # cost_type selects the device dtype (float64 under the port's
        # float64 mode; see bitops.device_dtype).
        dtype = bitops.device_dtype(getattr(cmodel, 'cost_type', 'float64'))
        self._log2d = bitops.pad_log2_dims(ctree.log2_dims_array, n_lanes,
                                           dtype, self.device)
        self._ul = engine_ul(ctree)
        dev = cmodel.device_params(ctree.inds_order)
        self._sparse_lanes = bitops.as_lanes(dev['sparse_lanes'],
                                             self.device)
        self._log2_n_projs = dev['log2_n_projs']

        self._generator, key_seed = resolve_seed(seed, self.device)
        self._state = self._init(ctree, key_seed)
        if min_ctree is not None:
            if (min_ctree.inds_order != ctree.inds_order or
                    len(min_ctree) != len(ctree)):
                raise ValueError("'min_ctree' is not consistent with "
                                 "'ctree'.")
            m = self._init(min_ctree, key_seed)
            s = self._state
            self._state = sa.SAStateIM(s.nodes, s.inds, s.hyper, s.lcc,
                                       s.log2_total, m.log2_total, m.nodes,
                                       m.inds, s.key)

        valid, msg = self.is_valid(atol=atol, return_message=True)
        if not valid:
            raise ValueError(msg)

    def _init(self, ctree, key_seed):
        return sa.init_state(ctree, key_seed, self._log2d, self._log2d.dtype,
                             sparse_lanes=self._sparse_lanes,
                             log2_n_projs=self._log2_n_projs,
                             device=self.device)

    # -- Optimization ---------------------------------------------------------

    def _cfg_for(self, prob):
        return sa.SweepConfig(n_leaves=self._cfg.n_leaves,
                              n_lanes=self._cfg.n_lanes,
                              disable_shared_inds=self.disable_shared_inds,
                              prob_kind=prob.kind)

    def update(self, prob: BaseProbability) -> None:
        """One SA sweep (reference update,
        infinite_memory/optimizer.hpp:90-221)."""
        self.update_many(prob, [getattr(prob, 'beta', 0.0)])

    def update_many(self, prob: BaseProbability, betas) -> dict:
        """One sweep per beta; returns the per-sweep metrics
        (``log2_total``, ``log2_min_total``, ``moves``) as numpy."""
        self._state, metrics = sa.run_sweeps(
            self._state, np.asarray(betas, dtype=np.float64), self._log2d,
            self._cfg_for(prob), self._sparse_lanes, self._log2_n_projs,
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
    def cmodel(self) -> SimpleCostModel:
        return self._cmodel

    def _exact_total(self, ctree: ContractionTree) -> int:
        if not self._cmodel.sparse_inds:
            return ctree.total_cost_exact()
        inds = ctree.inds
        return sum(self._cmodel.contraction_cost(
            inds[node.children[0]], inds[node.children[1]], inds[pos],
            ctree.dims) for pos, node in enumerate(ctree.nodes)
            if not node.is_leaf())

    @property
    def total_cost(self) -> Decimal:
        """Exact current total cost."""
        return Decimal(self._exact_total(self.ctree))

    @property
    def min_total_cost(self) -> Decimal:
        """Exact best total cost."""
        return Decimal(self._exact_total(self.min_ctree))

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
        """Structure + cache audit (reference
        infinite_memory/optimizer.hpp:223-251)."""
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

        # Cost cache audit: recompute with the same device arithmetic.
        s = self._state
        nl = self._cfg.n_leaves
        lcc_ref = sa.compute_lcc(s.nodes, s.inds, self._log2d,
                                 sparse_lanes=self._sparse_lanes,
                                 log2_n_projs=self._log2_n_projs)
        if not np.allclose(s.lcc[nl:].cpu().numpy(),
                           lcc_ref[nl:].cpu().numpy(), atol=max(atol, 1e-5),
                           rtol=1e-5):
            return False, "CostCache is not properly cached."
        if not torch.equal(s.hyper, sa.compute_hyper(s.nodes, s.inds)):
            return False, "HyperCache is not properly cached."

        # Min-cost consistency (same arithmetic as the engine).
        min_state = self._init(best, 0)
        if not log2_close(float(min_state.log2_total),
                          float(s.min_log2_total), max(atol, 1e-4)):
            return False, "Cost for min ctree is not correct."
        return True, ""

    # -- Pickle ---------------------------------------------------------------

    @classmethod
    def __build__(cls, ctree, cmodel, seed, disable_shared_inds, atol,
                  min_ctree):
        return cls(ctree, cmodel, seed=seed,
                   disable_shared_inds=disable_shared_inds, atol=atol,
                   min_ctree=min_ctree, device=_state_device(seed))

    def __reduce__(self):
        return type(self).__build__, (self.ctree, self._cmodel,
                                      self.prng_state,
                                      self.disable_shared_inds, self._atol,
                                      self.min_ctree)

    def __eq__(self, other: Any) -> bool:
        return (type(self) is type(other) and self.ctree == other.ctree and
                self.min_ctree == other.min_ctree and
                self._cmodel == other._cmodel and
                self.prng_state == other.prng_state)

    def __repr__(self) -> str:
        return (f'Optimizer(n_nodes={len(self._template)}, '
                f'log2_min_total_cost={self.log2_min_total_cost:.4f})')


def _state_device(state: str) -> str:
    """The device type a ``prng_state`` string was taken on (a pickled
    optimizer is rebuilt there)."""
    return state[len(_PREFIX):].partition(':')[0]

"""Parallel tempering over the replica batch (the port of
``tnco_tpu/parallel/tempering.py``: pure numpy, the same
``np.random.default_rng(seed)`` stream, so the ladder, ``perm`` and every
swap decision equal the JAX package's for a seed).

The reference (and this framework's default protocol) anneals every
replica on one shared beta schedule.  Parallel tempering instead pins a
LADDER of inverse temperatures to the replica lanes and exchanges
ladder positions between lanes with a Metropolis swap — hot lanes
explore, cold lanes refine, and configurations diffuse along the ladder
instead of being frozen by a one-way schedule.

Acceptance semantics: the engines' Metropolis rule accepts with
``u <= (new/old)^-beta`` on the COST RATIO
(include/tnco/optimize/prob/mh.hpp:45-59), so a chain at inverse
temperature ``beta`` samples the stationary density
``pi_beta(tree) ∝ total_cost(tree)^-beta``.  For two ladder-adjacent
temperatures ``beta_k < beta_{k+1}`` held by lanes ``i, j`` the swap

    pi_k(x_j) pi_{k+1}(x_i) / (pi_k(x_i) pi_{k+1}(x_j))
        = 2^{(beta_k - beta_{k+1}) (lt_i - lt_j)}

is accepted iff ``log2(u) <= (beta_k - beta_{k+1}) (lt_i - lt_j)`` with
``lt`` the lanes' CURRENT log2 total costs.  Only the temperature
labels move (an O(B) host permutation between device chunks); the
replica states never leave the device.

The runners accept per-lane beta rows ``[n_iters, B]`` on 'batched',
'walks' and 'multiwalk' (the walker reads one beta per iteration and
raises), and a tiled ladder row is exactly that.
"""

from dataclasses import dataclass, field

import numpy as np

__all__ = ['TemperingLadder']


@dataclass
class TemperingLadder:
    """Per-lane inverse-temperature ladder with Metropolis swaps.

    Args:
        n_replicas: Number of lanes ``B``.
        beta_min / beta_max: Ladder endpoints (inclusive).  The engines'
            rule is scale-matched to the annealed protocol's betas
            (e.g. 0..60 for the totals rule on these networks).
        spacing: 'linear' or 'geometric' (geometric requires
            ``beta_min > 0``).
        seed: Swap-move PRNG seed.
    """
    n_replicas: int
    beta_min: float = 0.0
    beta_max: float = 60.0
    spacing: str = 'linear'
    seed: int = 0
    _rng: np.random.Generator = field(init=False, repr=False)
    # ladder[k] = beta of ladder position k (ascending); perm[k] = lane
    # currently holding ladder position k.
    ladder: np.ndarray = field(init=False)
    perm: np.ndarray = field(init=False)
    _phase: int = field(default=0, init=False)
    swaps_proposed: int = field(default=0, init=False)
    swaps_accepted: int = field(default=0, init=False)

    def __post_init__(self):
        b = self.n_replicas
        if self.spacing == 'geometric':
            if self.beta_min <= 0:
                raise ValueError('geometric spacing needs beta_min > 0')
            self.ladder = np.geomspace(self.beta_min, self.beta_max, b)
        elif self.spacing == 'linear':
            self.ladder = np.linspace(self.beta_min, self.beta_max, b)
        else:
            raise ValueError(f'unknown spacing: {self.spacing!r}')
        self.perm = np.arange(b)
        self._rng = np.random.default_rng(self.seed)

    def lane_betas(self) -> np.ndarray:
        """Current per-lane beta assignment ``[B]``."""
        out = np.empty(self.n_replicas)
        out[self.perm] = self.ladder
        return out

    def betas_for(self, n_iters: int, dtype=np.float32) -> np.ndarray:
        """Constant per-lane beta rows ``[n_iters, B]`` for one chunk."""
        return np.tile(self.lane_betas().astype(dtype), (n_iters, 1))

    def swap(self, log2_totals) -> int:
        """One alternating-parity sweep of ladder-adjacent swap moves.

        ``log2_totals``: the lanes' CURRENT (not min) log2 total costs.
        Returns the number of accepted swaps and advances the parity.
        """
        lt = np.asarray(log2_totals, dtype=np.float64)
        b = self.n_replicas
        start = self._phase
        self._phase ^= 1
        ks = np.arange(start, b - 1, 2)
        if ks.size == 0:
            return 0
        i = self.perm[ks]
        j = self.perm[ks + 1]
        dbeta = self.ladder[ks] - self.ladder[ks + 1]   # < 0
        dlt = lt[i] - lt[j]
        log2_u = np.log2(self._rng.uniform(size=ks.size))
        accept = log2_u <= dbeta * dlt
        self.swaps_proposed += int(ks.size)
        self.swaps_accepted += int(accept.sum())
        self.perm[ks] = np.where(accept, j, i)
        self.perm[ks + 1] = np.where(accept, i, j)
        return int(accept.sum())

    @property
    def swap_rate(self) -> float:
        return self.swaps_accepted / max(1, self.swaps_proposed)

"""Acceptance probabilities for the SA kernels (the port's copy of
``tnco_tpu/optimize/prob.py``).

Reference: tnco/optimize/prob.py:25-151 and
include/tnco/optimize/prob/{base,greedy,mh}.hpp.  Here a probability is a
small host object carrying a ``kind`` consumed statically by the kernel
(the device evaluates the acceptance in the log2 domain, see
``tnco_tpu_torch.ops.costs.mh_log2_accept``) plus a ``__call__`` for
host-side evaluation in the linear domain (used by the differential
tests).
"""

from typing import Any
from warnings import warn

__all__ = ['BaseProbability', 'Greedy', 'MetropolisHastings',
           'SimulatedAnnealing']


class BaseProbability:
    """Always-accept probability (reference prob/base.hpp:43-47)."""

    kind = 'base'

    def __init__(self, cost_type: str = 'float64') -> None:
        self.cost_type = str(cost_type)

    def __call__(self, delta_cost, old_cost) -> float:
        del delta_cost, old_cost
        return 1.0

    def __eq__(self, other: Any) -> bool:
        return type(self) is type(other)

    def __repr__(self) -> str:
        return f'{type(self).__name__}(cost_type={self.cost_type})'

    def __reduce__(self):
        return type(self), (self.cost_type,)


class Greedy(BaseProbability):
    """Downhill-only acceptance (reference prob/greedy.hpp:38-42)."""

    kind = 'greedy'

    def __call__(self, delta_cost, old_cost) -> float:
        del old_cost
        return 1.0 if delta_cost <= 0 else 0.0


class MetropolisHastings(BaseProbability):
    """Relative-cost Metropolis acceptance.

    ``p = 1`` if ``delta <= 0``; ``0`` if ``old == 0``; else
    ``(1 + delta/old)^(-beta)`` — note: *relative* cost, not the textbook
    ``exp(-beta * delta)`` (reference prob/mh.hpp:45-59).

    Examples:
        >>> from tnco_tpu_torch.optimize.prob import MetropolisHastings
        >>> mh = MetropolisHastings(beta=2.0)
        >>> mh(-1.0, 10.0)
        1.0
        >>> round(mh(10.0, 10.0), 4)  # (1 + 1)^-2
        0.25
        >>> mh(1.0, 0.0)
        0.0
    """

    kind = 'mh'

    def __init__(self, beta: float = 0.0, cost_type: str = 'float64') -> None:
        super().__init__(cost_type)
        self.beta = float(beta)

    def __call__(self, delta_cost, old_cost) -> float:
        if delta_cost <= 0:
            return 1.0
        if old_cost == 0:
            return 0.0
        return float((1 + delta_cost / old_cost)**(-self.beta))

    def __eq__(self, other: Any) -> bool:
        return type(self) is type(other) and self.beta == other.beta

    def __repr__(self) -> str:
        return (f'MetropolisHastings(beta={self.beta}, '
                f'cost_type={self.cost_type})')

    def __reduce__(self):
        return type(self), (self.beta, self.cost_type)


def SimulatedAnnealing(*args, **kwargs) -> MetropolisHastings:
    """Deprecated alias of :class:`MetropolisHastings`.

    Reference: tnco/optimize/prob.py:91-115.
    """
    warn("'SimulatedAnnealing' is deprecated; use 'MetropolisHastings'.",
         DeprecationWarning, stacklevel=2)
    return MetropolisHastings(*args, **kwargs)

"""Log2-domain total-cost arithmetic on torch tensors.

Every cost lives in the log2 domain; sums of linear costs are evaluated
with a max-shifted exponential sum whose reduction order is pinned (the
pairwise-halving tree of ``tnco_tpu/ops/costs.py:42-64``), so every
layout of the same values gives the same per-element operation tree.
Exactness, where required, is restored on the host with Python bigints.
"""

import torch

from tnco_tpu_torch.ops.bitops import pairwise_sum_last, width

__all__ = ['ccost_log2', 'pairwise_sum', 'log2_total_from_lcc',
           'log2_total_from_lcc_last', 'new_total_log2', 'delta_log2_local',
           'mh_log2_accept']

# Floor for the scaled linear sum: if the true new total underflows this,
# the move is a colossal improvement and is accepted regardless.
_SCALED_FLOOR = 2.0**-60


def ccost_log2(union_lanes, log2_dims_padded, *, sparse_lanes=None,
               log2_n_projs=None):
    """log2 of the simple contraction cost of ``in1 | in2`` lanes
    (``tnco_tpu/ops/costs.py:26-39``).

    - Dense: the width of the union (infinite_memory/cost_model/
      simple.hpp:65-83).
    - Sparse: the dense part's width plus ``min(sparse part's width,
      log2_n_projs)`` (simple_sparse_inds.hpp:37-49).
    """
    if sparse_lanes is None:
        return width(union_lanes, log2_dims_padded)
    dense = width(union_lanes & ~sparse_lanes, log2_dims_padded)
    sparse = width(union_lanes & sparse_lanes, log2_dims_padded)
    return dense + torch.clamp(sparse, max=float(log2_n_projs))


def pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over axis 0 with the pinned pairwise-halving order."""
    n = x.shape[0]
    if n == 0:
        return x.new_zeros(x.shape[1:])
    p = 1 << (n - 1).bit_length() if n > 1 else 1
    if p != n:
        x = torch.cat([x, x.new_zeros((p - n,) + x.shape[1:])], dim=0)
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        x = x[:h] + x[h:]
    return x[0]


def log2_total_from_lcc(lcc: torch.Tensor, n_leaves: int) -> torch.Tensor:
    """Stable ``log2(sum_i 2^lcc[i])`` over internal nodes (node axis 0;
    leaves first, so internal nodes are ``lcc[n_leaves:]``)."""
    internal = lcc[n_leaves:]
    if internal.shape[0] == 0:
        return torch.full(internal.shape[1:], -torch.inf, dtype=lcc.dtype,
                          device=lcc.device)
    m = internal.amax(dim=0)
    s = pairwise_sum(torch.exp2(internal - m[None]))
    return m + torch.log2(s)


def log2_total_from_lcc_last(lcc: torch.Tensor,
                             n_leaves: int) -> torch.Tensor:
    """:func:`log2_total_from_lcc` with the node axis LAST (the same
    element pairing, so value-identical to the transposed form)."""
    internal = lcc[..., n_leaves:]
    if internal.shape[-1] == 0:
        return torch.full(internal.shape[:-1], -torch.inf, dtype=lcc.dtype,
                          device=lcc.device)
    m = internal.amax(dim=-1)
    s = pairwise_sum_last(torch.exp2(internal - m[..., None]))
    return m + torch.log2(s)


def new_total_log2(lt, l_a, l_b, ln_a, ln_b):
    """log2 of ``total - ccost_A - ccost_B + new_ccost_A + new_ccost_B``.

    Max-shifted linear evaluation with the same operation order as the
    JAX package; the clamp covers the move-removes-everything edge.
    """
    m = torch.maximum(lt, torch.maximum(ln_a, ln_b))
    s = (torch.exp2(lt - m) - torch.exp2(l_a - m) - torch.exp2(l_b - m) +
         torch.exp2(ln_a - m) + torch.exp2(ln_b - m))
    return m + torch.log2(torch.clamp(s, min=_SCALED_FLOOR))


def delta_log2_local(lt, l_a, l_b, ln_a, ln_b):
    """``log2(new_total) - log2(total)`` at full relative precision
    (``tnco_tpu/ops/costs.py:121-146``, same op order): the local form
    ``log1p((2^ln_a + 2^ln_b - 2^l_a - 2^l_b) / 2^lt) / ln 2`` keeps the
    sign and leading digits of deltas far below the total, where
    ``new_total_log2(...) - lt`` rounds to zero.  Same clamp at the
    move-removes-nearly-everything edge."""
    m = torch.maximum(torch.maximum(l_a, l_b), torch.maximum(ln_a, ln_b))
    d = (torch.exp2(ln_a - m) + torch.exp2(ln_b - m) -
         torch.exp2(l_a - m) - torch.exp2(l_b - m))
    x = d * torch.exp2(m - lt)
    x = torch.clamp(x, min=_SCALED_FLOOR - 1.0)
    return torch.log1p(x) * 1.4426950408889634


def mh_log2_accept(log2_u, beta, l_new, l_old):
    """Metropolis-Hastings acceptance in the log2 domain: ``log2(u) <=
    -beta * (log2_new - log2_old)`` (the reference's ``(new / old) ^
    -beta``, optimize/prob/mh.hpp:45-59)."""
    return log2_u <= -beta * (l_new - l_old)

"""Finite-width configuration, the host greedy slicer and the
per-replica helpers of the rescue (from ``tnco_tpu/kernels/sa_finite.py``:
``SweepConfigFW`` :46-52, ``_wfn`` :93, ``compute_lcc_fw`` :103,
``_pack_bits`` :120, ``greedy_slices_host`` :204-281,
``_pick_rescue_slices`` :331-353).

The slicer reproduces the reference greedy slice selection
(finite_width/greedy/utils.hpp:24-125): indices ranked by how many
over-width tensors contain them (then larger log2 dim, then random
jitter), and per node the top-ranked candidates are sliced until the node
fits ``max_width``.
"""

from dataclasses import dataclass

import numpy as np
import torch

from tnco_tpu_torch.ops import costs as costs_ops
from tnco_tpu_torch.ops.bitops import expand_bits

__all__ = ['SweepConfigFW', 'greedy_slices_host', 'compute_lcc_fw', 'NULL']

NULL = -1
_WIDTH_EPS = 1e-4  # f32 slack on width comparisons


@dataclass(frozen=True)
class SweepConfigFW:
    n_leaves: int
    n_lanes: int
    disable_shared_inds: bool = False
    prob_kind: str = 'mh'
    max_new_slices: int = 0


def _wfn(lanes, log2d, sparse_lanes=None, log2_n_projs=None):
    """Width of an index set == its log2 cost (finite_width/cost_model/
    simple.hpp:38-57)."""
    return costs_ops.ccost_log2(lanes, log2d, sparse_lanes=sparse_lanes,
                                log2_n_projs=log2_n_projs)


def compute_lcc_fw(nodes, inds, slices, log2d, sparse_lanes=None,
                   log2_n_projs=None):
    """Per-node log2 cost of one replica with slices: ``width(in1 | in2 |
    slices)``, -inf at leaves.  ``nodes: int32 [N, 3]`` (c0, c1, par),
    ``inds: int32 [N, W]``, ``slices: int32 [W]``, ``log2d: [W*32]``."""
    internal = nodes[:, 0] != NULL
    c0 = torch.where(internal, nodes[:, 0], 0).long()
    c1 = torch.where(internal, nodes[:, 1], 0).long()
    union = inds[c0] | inds[c1] | slices[None, :]
    lcc = _wfn(union, log2d, sparse_lanes, log2_n_projs)
    return torch.where(internal, lcc, -torch.inf).to(log2d.dtype)


def _pack_bits(bits01, n_lanes):
    """0/1 bits ``[n_lanes * 32, ...]`` -> int32 bit-pattern words
    ``[n_lanes, ...]`` (bit ``s`` of word ``w`` from entry ``32*w + s``)."""
    bits = bits01.reshape((n_lanes, 32) + tuple(bits01.shape[1:]))
    sh = torch.arange(32, dtype=torch.int64, device=bits01.device)
    sh = sh.reshape((1, 32) + (1,) * (bits01.dim() - 1))
    packed = (bits.to(torch.int64) << sh).sum(dim=1)
    packed = torch.where(packed >= 2**31, packed - 2**32, packed)
    return packed.to(torch.int32)


def _cumsum_blocked(x, base=16):
    """Inclusive float sum along axis 0 in the order XLA gives
    ``jnp.cumsum`` on the CPU: blocks of ``base`` summed one term at a
    time, each block offset by the exclusive scan of the block totals
    (recursively).  torch's ``cumsum`` sums in double on the CPU and in
    parallel on the card; this order makes the slicers' prefix widths
    equal the JAX package's bitwise on both."""
    n = x.shape[0]
    if n <= base:
        out = [x[0]]
        for i in range(1, n):
            out.append(out[-1] + x[i])
        return torch.stack(out)
    nb = -(-n // base)
    xp = torch.cat([x, x.new_zeros((nb * base - n,) + x.shape[1:])])
    blocks = xp.reshape((nb, base) + x.shape[1:])
    within = [blocks[:, 0]]
    for i in range(1, base):
        within.append(within[-1] + blocks[:, i])
    within = torch.stack(within, dim=1)
    inc = _cumsum_blocked(within[:, -1], base)
    excl = torch.cat([torch.zeros_like(inc[:1]), inc[:-1]])
    out = within + excl[:, None]
    return out.reshape((nb * base,) + x.shape[1:])[:n]


def _pick_rescue_slices(prio, cand_lanes, k, start_width, max_width, log2d,
                        n_lanes):
    """Random candidate bits, added one by one until the width fits (the
    rescue selection, greedy/optimizer.hpp:230-269), for every replica.

    Random order without replacement, at most ``k`` picks, stop once
    ``start_width - sum(log2 dims of picks) <= max_width``: a prefix
    threshold over the bits sorted by ``-(prio * cand + cand)`` (the
    candidates first, in ``prio`` order), a STABLE argsort as
    ``jnp.argsort`` is, since every non-candidate ties at -0.

    ``prio: [n_bits, B]`` uniform priorities (the JAX package draws them
    from the replica's key), ``cand_lanes: int32 [W, B]``, ``start_width:
    [B]``, ``log2d: [n_bits]``.  Returns ``int32 [W, B]``.
    """
    dtype = log2d.dtype
    cand = expand_bits(cand_lanes.T, dtype).T                # [n_bits, B]
    order = torch.argsort(-(prio * cand + cand), dim=0, stable=True)
    cand_sorted = cand.gather(0, order)
    removed = cand_sorted * log2d[order]
    w_before = start_width - (_cumsum_blocked(removed) - removed)
    rank = torch.cumsum(cand_sorted, dim=0) - cand_sorted    # exact counts
    selected_sorted = ((cand_sorted > 0) &
                       (w_before > max_width + _WIDTH_EPS) & (rank < k))
    selected = torch.zeros_like(selected_sorted).scatter_(0, order,
                                                          selected_sorted)
    return _pack_bits(selected, n_lanes)


def greedy_slices_host(inds, log2_dims, max_width, rng, *,
                       skip_bits=None, sparse_bits=None,
                       log2_n_projs=None):
    """Host greedy slicer for replica-batch initialization.

    Args:
        inds: ``uint32[N, W]`` index lanes.
        log2_dims: ``float64[n_inds]`` (unpadded).
        rng: ``random.Random`` (or anything with ``random()``).

    Returns ``uint32[W]`` slice lanes.
    """
    n, w = inds.shape
    n_bits = w * 32
    log2d = np.zeros(n_bits)
    log2d[:len(log2_dims)] = np.asarray(log2_dims, dtype=np.float64)
    shifts = np.arange(32, dtype=np.uint32)
    bits = (((inds[:, :, None] >> shifts[None, None, :]) & 1)
            .astype(bool).reshape(n, n_bits))
    if sparse_bits is None:
        width = bits @ log2d
    else:
        sp = np.asarray(sparse_bits, dtype=bool)
        width = ((bits & ~sp) @ log2d +
                 np.minimum((bits & sp) @ log2d, log2_n_projs))
    big = (width > max_width + _WIDTH_EPS).astype(np.float64)
    n_big = big @ bits
    jitter = np.asarray([rng.random() for _ in range(n_bits)])
    order = np.argsort(-(n_big * 1e6 + log2d + 1e-4 * jitter),
                       kind='stable')
    skip = (np.zeros(n_bits, dtype=bool) if skip_bits is None else
            np.asarray(skip_bits, dtype=bool))
    log2d_sorted = log2d[order]
    skip_sorted = skip[order]
    sp = None if sparse_bits is None else \
        np.asarray(sparse_bits, dtype=bool)
    sp_sorted = None if sp is None else sp[order]

    slices = np.zeros(n_bits, dtype=bool)
    for t in range(n):
        cand = bits[t] & ~slices
        if sp is None:
            sw = float(log2d @ cand)
        else:
            sw = float(log2d @ (cand & ~sp) +
                       min(log2d @ (cand & sp), log2_n_projs))
        if sw <= max_width + _WIDTH_EPS:
            continue
        cand_sorted = cand[order] & ~skip_sorted
        removed = cand_sorted * log2d_sorted
        if sp_sorted is None:
            cum = np.cumsum(removed) - removed
            w_before = sw - cum
        else:
            dense_rm = removed * ~sp_sorted
            sp_rm = removed * sp_sorted
            cum_d = np.cumsum(dense_rm) - dense_rm
            cum_s = np.cumsum(sp_rm) - sp_rm
            w_d0 = float(log2d @ (cand & ~sp))
            w_s0 = float(log2d @ (cand & sp))
            w_before = (w_d0 - cum_d +
                        np.minimum(w_s0 - cum_s, log2_n_projs))
        sel = cand_sorted & (w_before > max_width + _WIDTH_EPS)
        slices[order[sel]] = True

    packed = np.packbits(slices.reshape(w, 32)[:, ::-1].astype(np.uint8),
                         axis=1)
    return np.asarray(
        [int.from_bytes(bytes(row), 'big') for row in packed],
        dtype=np.uint32)

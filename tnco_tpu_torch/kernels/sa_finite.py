"""Finite-width configuration and the host greedy slicer (from
``tnco_tpu/kernels/sa_finite.py:43-54,204-281``; numpy only).

The slicer reproduces the reference greedy slice selection
(finite_width/greedy/utils.hpp:24-125): indices ranked by how many
over-width tensors contain them (then larger log2 dim, then random
jitter), and per node the top-ranked candidates are sliced until the node
fits ``max_width``.
"""

from dataclasses import dataclass

import numpy as np

__all__ = ['SweepConfigFW', 'greedy_slices_host', 'NULL']

NULL = -1
_WIDTH_EPS = 1e-4  # f32 slack on width comparisons


@dataclass(frozen=True)
class SweepConfigFW:
    n_leaves: int
    n_lanes: int
    disable_shared_inds: bool = False
    prob_kind: str = 'mh'
    max_new_slices: int = 0


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

"""Finite-width batch state, its host initializer and the plane slicer
(from ``tnco_tpu/kernels/sa_finite_batched.py``: ``SABatchFW`` :28,
``_pc_width`` :102, ``_greedy_slices_fast`` :163-325,
``init_batch_fw`` :783-883).

Layout is the reference's replica-minor one (replica axis LAST; ``keys``
replica-first), with ``uint32`` words held as ``int32`` bit patterns.
"""

from dataclasses import dataclass, fields
from random import Random

import numpy as np
import torch

from tnco_tpu_torch.kernels.gather import gather_bn, gather_gbn
from tnco_tpu_torch.kernels.sa_finite import _WIDTH_EPS, greedy_slices_host
from tnco_tpu_torch.ops.bitops import popcount32

__all__ = ['SABatchFW', 'init_batch_fw']


@dataclass
class SABatchFW:
    """Replica-minor finite-width state (torch tensors on one device).

    ``c0/c1/par: int32 [N, B]``; ``inds/hyper/min_inds: int32 [N, W, B]``
    bit patterns; ``lcc/width: float [N, B]`` (log2 contraction costs
    with slices, pre-slicing widths); ``slices/min_slices: int32 [W, B]``;
    ``log2_total/min_log2_total: float [B]``; ``keys: int32 [B, 2]``
    (the replicas' seed words, carried for the layout; draws come from a
    ``torch.Generator``).
    """
    c0: torch.Tensor
    c1: torch.Tensor
    par: torch.Tensor
    inds: torch.Tensor
    hyper: torch.Tensor
    lcc: torch.Tensor
    width: torch.Tensor
    slices: torch.Tensor
    log2_total: torch.Tensor
    min_log2_total: torch.Tensor
    min_c0: torch.Tensor
    min_c1: torch.Tensor
    min_par: torch.Tensor
    min_inds: torch.Tensor
    min_slices: torch.Tensor
    keys: torch.Tensor

    @classmethod
    def field_names(cls):
        return tuple(f.name for f in fields(cls))


def _pc_width(lanes, uniform_log2, dtype, word_axis):
    """Popcount width for UNIFORM index dims: ``log2(dim) * popcount``
    (bitwise-identical to the pinned pairwise tree for power-of-two
    dims)."""
    pc = popcount32(lanes).sum(dim=word_axis, dtype=torch.int32)
    return pc.to(dtype) * torch.tensor(uniform_log2, dtype=dtype,
                                       device=lanes.device)


def _greedy_slices_fast(vals, vals_planes, width, jitter, max_width,
                        log2d_w32, skip_wb, uniform_log2, window=128):
    """Sorted-space greedy slicer for UNIFORM power-of-two dims.

    Output-identical to the JAX package's ``_greedy_slices_fast``: the
    entry over-width set is a superset of every node that can need
    slicing (widths only shrink as slices grow), the score order is fixed
    for the call so the loop runs in sorted score space, and every width
    is ``log2(dim) * an exact integer count``.  Two changes of form, same
    values:

    - the candidates-before prefix is an exact int32 ``cumsum`` (the TPU
      path used a 128-block bf16 triangular matmul of 0/1 values);
    - the score order is a STABLE argsort, as ``jnp.argsort`` is: in f32
      ``n_big * 1e6`` swallows ``log2d`` and the jitter once ``n_big``
      reaches ~17, so ties are common and their order matters.

    ``vals`` is the packed ``[F, B, N]`` state and ``vals_planes`` its
    index-plane range: the row gathers read the planes in place.
    ``width: [N, B]`` pre-slicing widths; ``jitter: [n_bits, B]`` (the
    caller draws it); ``skip_wb``: ``int32 [W]`` lanes never sliced.
    Returns ``int32 [W, B]`` slice lanes.
    """
    lo, hi = vals_planes
    n, w, b = vals.shape[2], hi - lo, vals.shape[1]
    dev = vals.device
    n_bits = w * 32
    nbp = max(128, -(-n_bits // 128) * 128)
    dtype = log2d_w32.dtype
    log2d_flat = log2d_w32.reshape(n_bits)
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    ul = torch.tensor(uniform_log2, dtype=dtype, device=dev)
    window = min(window, n)
    thr = torch.as_tensor(max_width, dtype=dtype, device=dev) + _WIDTH_EPS

    # --- entry: over-width node ids, ascending per replica ---
    iota_n = torch.arange(n, dtype=torch.int32, device=dev)
    over0 = width > thr
    ids_sorted = torch.sort(
        torch.where(over0, iota_n[:, None], n), dim=0).values
    max_count = int(over0.sum(dim=0).max()) if b else 0

    def gather_rows(ids_bk):
        return gather_gbn(vals, ids_bk, planes=vals_planes)

    def window_ids(offset):
        # lax.dynamic_slice clamps the start so the window stays in range.
        start = min(offset, n - window)
        ids_w = ids_sorted[start:start + window]
        return torch.where(ids_w < n, ids_w, -1).T.contiguous()  # [b, K]

    # n_big[j, b] = #over-width nodes whose index set contains bit j,
    # summed over the gathered over rows only (pad ids give zero rows).
    acc = torch.zeros((w, b, 32), dtype=torch.int32, device=dev)
    offset = 0
    while offset < max_count:
        rows = gather_rows(window_ids(offset))               # [w, b, K]
        bits = (rows[:, :, :, None] >> shifts) & 1
        acc += bits.sum(dim=2, dtype=torch.int32)
        offset += window
    n_big = acc.permute(0, 2, 1).reshape(n_bits, b).to(dtype)
    score = n_big * 1e6 + log2d_flat[:, None] + 1e-4 * jitter
    order = torch.argsort(-score, dim=0, stable=True)        # [n_bits, b]
    inv = torch.argsort(order, dim=0)                        # inverse perm

    # Sorted-space addressing: sorted position q of replica b reads bit
    # order[q, b] = word order >> 5, bit order & 31; pad ids -1 -> 0 bits.
    ord_bq = order.T.to(torch.int32)                         # [b, n_bits]
    pad = nbp - n_bits
    word_q = torch.nn.functional.pad(ord_bq >> 5, (0, pad),
                                     value=-1).contiguous()
    bit_q = torch.nn.functional.pad(ord_bq & 31, (0, pad)).contiguous()

    skip_words = skip_wb.reshape(1, w).expand(b, w).contiguous()
    skip_srt = ((gather_bn(skip_words, word_q) >> bit_q) & 1).to(torch.int8)
    valid = torch.zeros((b, nbp), dtype=torch.int8, device=dev)
    valid[:, :n_bits] = 1
    not_skip = (1 - skip_srt) * valid

    def one_node(xs, sl):
        avail = xs * (1 - sl)
        cnt = avail.sum(dim=1, dtype=torch.int32)
        sw = cnt.to(dtype) * ul                              # exact
        cand = avail * not_skip
        # Exclusive prefix count of candidates in sorted order (exact).
        cb = (torch.cumsum(cand, dim=1, dtype=torch.int32) - cand).to(dtype)
        w_before = sw[:, None] - ul * cb
        selected = (cand > 0) & (w_before > thr)
        return sl | selected.to(torch.int8)

    sl = torch.zeros((b, nbp), dtype=torch.int8, device=dev)
    offset = 0
    while offset < max_count:
        g1 = gather_rows(window_ids(offset))                 # [w, b, K]
        rows_wb = g1.permute(2, 1, 0).contiguous()           # [K, b, w]
        word_srt = gather_gbn(rows_wb, word_q)               # [K, b, nbp]
        bits_srt = ((word_srt >> bit_q[None]) & 1).to(torch.int8)
        trip = min(max(max_count - offset, 0), window)
        for k in range(trip):
            sl = one_node(bits_srt[k], sl)
        offset += window

    # Back to lane space: lane bit j of replica b = sl[b, inv[j, b]].
    lane_bits = gather_bn(sl.to(torch.int32).contiguous(),
                          inv.T.to(torch.int32).contiguous())  # [b, n_bits]
    lb = lane_bits.reshape(b, w, 32).to(torch.int64)
    packed = (lb << shifts.to(torch.int64)).sum(dim=2)       # < 2**32
    packed = torch.where(packed >= 2**31, packed - 2**32, packed)
    return packed.to(torch.int32).T.contiguous()             # [w, b]


def init_batch_fw(ctrees, seeds, max_width, log2_dims_padded, *,
                  skip_lanes=None, dtype=np.float32, device='cpu'):
    """Builds a replica-minor finite-width batch on the host (numpy) and
    uploads it once to ``device``.

    Initial slices come from the host greedy slicer with per-replica
    ``random.Random(seed)`` jitter, as in the JAX package, so ``c0, c1,
    par, inds, hyper, lcc, width, slices`` and the totals equal its
    ``init_batch_fw`` bitwise.  ``keys`` holds the seed words
    ``[0, seed]`` (the draws come from a ``torch.Generator``).  Sparse
    indices are not ported yet.
    """
    n = len(ctrees[0])
    b = len(ctrees)
    w = ctrees[0].inds_array.shape[1]
    n_leaves = ctrees[0].n_leaves
    log2d = np.asarray(log2_dims_padded, dtype=np.float64)
    mw = float(max_width)

    c0 = np.empty((n, b), dtype=np.int32)
    c1 = np.empty((n, b), dtype=np.int32)
    par = np.empty((n, b), dtype=np.int32)
    inds = np.empty((n, w, b), dtype=np.uint32)
    for i, ctree in enumerate(ctrees):
        nodes = ctree.nodes_array
        c0[:, i] = nodes[:, 0]
        c1[:, i] = nodes[:, 1]
        par[:, i] = nodes[:, 2]
        inds[:, :, i] = ctree.inds_array

    shifts = np.arange(32, dtype=np.uint32)

    def expand(lanes):  # [..., w] -> bool [..., w*32]
        bits = (lanes[..., :, None] >> shifts) & 1
        return bits.astype(bool).reshape(*lanes.shape[:-1], w * 32)

    skip_bits = None if skip_lanes is None else \
        expand(np.asarray(skip_lanes, dtype=np.uint32))

    slices = np.empty((w, b), dtype=np.uint32)
    for i in range(b):
        slices[:, i] = greedy_slices_host(
            inds[:, :, i], log2d, mw, Random(int(seeds[i]) & 0x7FFFFFFF),
            skip_bits=skip_bits)

    internal = c0 >= 0
    c0s = np.where(internal, c0, 0)
    c1s = np.where(internal, c1, 0)
    inds_c0 = np.take_along_axis(inds, c0s[:, None, :], axis=0)
    inds_c1 = np.take_along_axis(inds, c1s[:, None, :], axis=0)
    hyper = np.where(internal[:, None, :], inds & inds_c0 & inds_c1,
                     np.uint32(0))

    lcc = np.empty((n, b), dtype=np.float64)
    width = np.empty((n, b), dtype=np.float64)
    for i in range(b):
        union = expand(inds_c0[:, :, i] | inds_c1[:, :, i] |
                       slices[None, :, i])
        lcc[:, i] = union @ log2d
        width[:, i] = expand(inds[:, :, i]) @ log2d
    lcc = np.where(internal, lcc, -np.inf).astype(dtype)
    width = width.astype(dtype)

    internal_lcc = lcc[n_leaves:]
    if internal_lcc.shape[0]:
        m = internal_lcc.max(axis=0)
        lt = (m + np.log2(np.exp2(internal_lcc - m[None, :]).sum(axis=0))
              ).astype(dtype)
    else:
        lt = np.full(b, -np.inf, dtype=dtype)

    keys = np.stack([np.zeros(b, dtype=np.uint32),
                     np.asarray([int(s) & 0xFFFFFFFF for s in seeds],
                                dtype=np.uint32)], axis=1)

    def up(x):
        x = np.ascontiguousarray(x)
        if x.dtype == np.uint32:
            x = x.view(np.int32)
        return torch.from_numpy(x).to(device)

    return SABatchFW(up(c0), up(c1), up(par), up(inds), up(hyper), up(lcc),
                     up(width), up(slices), up(lt), up(lt), up(c0), up(c1),
                     up(par), up(inds), up(slices), up(keys))

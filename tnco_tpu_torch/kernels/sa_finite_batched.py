"""Finite-width batch state, its host initializer, the slice-aware cost
and the greedy slicers (from ``tnco_tpu/kernels/sa_finite_batched.py``:
``SABatchFW`` :28, ``_pc_width`` :102, ``_lcc_fw_b`` :125-160,
``_greedy_slices_fast`` :163-325, ``_greedy_slices_b`` :328-508,
``init_batch_fw`` :783-883).

Layout is the reference's replica-minor one (replica axis LAST; ``keys``
replica-first), with ``uint32`` words held as ``int32`` bit patterns.
"""

from dataclasses import dataclass, fields
from random import Random

import numpy as np
import torch

from tnco_tpu_torch.kernels.gather import gather_bn, gather_gbn
from tnco_tpu_torch.kernels.sa_batched import _width_b
from tnco_tpu_torch.kernels.sa_finite import _WIDTH_EPS, greedy_slices_host
from tnco_tpu_torch.ops.bitops import popcount32

__all__ = ['SABatchFW', 'init_batch_fw']

_SPARSE = ('Sparse indices are not ported yet (ROADMAP queue 1, left out '
           'of slice 1, e).')


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

    Output-identical to the reference path (``_greedy_slices_b`` without
    ``uniform_log2``): the entry over-width set is a superset of every
    node that can need slicing (widths only shrink as slices grow), the
    score order is fixed for the call so the loop runs in sorted score
    space, and every width is ``log2(dim) * an exact integer count``.
    The over-width ids are read in windows of ``window`` nodes, the last
    one padded with empty ids.  The JAX package's ``_greedy_slices_fast``
    clamps the last window's start to ``n - window`` instead, which, for
    ``n`` not a multiple of the window and more than ``window * (n //
    window)`` nodes over the cap, counts earlier nodes twice and never
    reaches the last ones; elsewhere the two are equal.  Two changes of
    form, same values:

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

    # --- entry: over-width node ids, ascending per replica, padded with
    # n (-> -1, a zero row) to whole windows ---
    iota_n = torch.arange(n, dtype=torch.int32, device=dev)
    over0 = width > thr
    ids_sorted = torch.sort(
        torch.where(over0, iota_n[:, None], n), dim=0).values
    ids_sorted = torch.nn.functional.pad(
        ids_sorted, (0, 0, 0, -n % window), value=n)
    max_count = int(over0.sum(dim=0).max()) if b else 0

    def gather_rows(ids_bk):
        return gather_gbn(vals, ids_bk, planes=vals_planes)

    def window_ids(offset):
        ids_w = ids_sorted[offset:offset + window]
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
    return _pack_bits(lane_bits.reshape(b, w, 32), 2).T.contiguous()


def _pack_bits(bits, axis):
    """0/1 bits with 32 entries on ``axis`` -> int32 bit-pattern words."""
    shape = [1] * bits.dim()
    shape[axis] = 32
    sh = torch.arange(32, dtype=torch.int64, device=bits.device)
    packed = (bits.to(torch.int64) << sh.reshape(shape)).sum(dim=axis)
    packed = torch.where(packed >= 2**31, packed - 2**32, packed)
    return packed.to(torch.int32)


def _lcc_fw_b(c0, c1, inds, slices, log2d_w32, sparse_wb=None,
              log2_n_projs=None, uniform_log2=None):
    """``[N, B]`` slice-aware log2 cost per node (leaves -> -inf): the
    width of ``inds[c0] | inds[c1] | slices``.

    With ``uniform_log2`` the child rows are read through K1
    (:func:`gather_gbn`) and the width is the popcount times the common
    log2 dim; otherwise each node's width is the pinned tree of
    :func:`_width_b`.  ``inds: [N, W, B]`` may be a strided view.
    """
    if sparse_wb is not None or log2_n_projs is not None:
        raise NotImplementedError(_SPARSE)
    internal = c0 != -1
    dtype = log2d_w32.dtype
    if uniform_log2 is not None:
        inds_wbn = inds.permute(1, 2, 0).contiguous()         # [W, B, N]
        ids0 = torch.where(internal, c0, -1).T.contiguous()    # [B, N]
        ids1 = torch.where(internal, c1, -1).T.contiguous()
        union = (gather_gbn(inds_wbn, ids0) | gather_gbn(inds_wbn, ids1) |
                 slices[:, :, None])                           # [W, B, N]
        lcc = _pc_width(union, uniform_log2, dtype, word_axis=0).T
    else:
        w = inds.shape[1]

        def rows(ids):
            ids = torch.where(internal, ids, 0).long()
            return torch.gather(inds, 0, ids[:, None, :].expand(-1, w, -1))

        lcc = _width_nodes(rows(c0) | rows(c1) | slices[None], log2d_w32)
    return torch.where(internal, lcc, -torch.inf).to(dtype)


def _cumsum_blocked(x, base=16):
    """Inclusive float sum along axis 0 in the order XLA gives
    ``jnp.cumsum`` on the CPU: blocks of ``base`` summed one term at a
    time, each block offset by the exclusive scan of the block totals
    (recursively).  torch's ``cumsum`` sums in double on the CPU and in
    parallel on the card; this order makes the slicer's prefix widths
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


def _greedy_slices_b(c0, inds, width, jitter, max_width, log2d_w32,
                     skip_wb, sparse_wb=None, log2_n_projs=None,
                     uniform_log2=None):
    """Lane-major greedy slicer, the reference path of the JAX package's
    ``_greedy_slices_b`` (reference finite_width/greedy/utils.hpp:24-125).

    Bits are ranked once per call by ``n_big * 1e6 + log2 dim + 1e-4 *
    jitter`` (``n_big``: over-width nodes holding the bit; a STABLE
    argsort, as ``jnp.argsort``).  Then, round by round, the first
    over-width node not yet processed takes, in rank order, every
    candidate bit while the node's width before that bit (its sliced
    width less the candidates ranked ahead of it) is over the cap.
    Without ``uniform_log2`` a round processes one node and recomputes
    every node's sliced width with the pinned tree; with it, a round
    processes 8 nodes on popcount widths (output-identical).  Uniform
    INTEGER log2 dims go to :func:`_greedy_slices_fast`, which gives the
    same slices.

    ``inds: [N, W, B]`` (may be a strided view), ``width: [N, B]``
    pre-slicing widths, ``jitter: [n_bits, B]`` (the caller draws it),
    ``skip_wb``: int32 ``[W]`` or ``[W, 1]`` lanes never sliced.  ``c0``
    is unused (the reference's signature).  Returns int32 ``[W, B]``.
    """
    del c0
    if sparse_wb is not None or log2_n_projs is not None:
        raise NotImplementedError(_SPARSE)
    if uniform_log2 is not None and float(uniform_log2).is_integer():
        vals = inds.permute(1, 2, 0).contiguous()             # [W, B, N]
        return _greedy_slices_fast(vals, (0, vals.shape[0]), width, jitter,
                                   max_width, log2d_w32, skip_wb.reshape(-1),
                                   uniform_log2)
    n, w, b = inds.shape
    dev = inds.device
    n_bits = w * 32
    dtype = log2d_w32.dtype
    log2d_flat = log2d_w32.reshape(n_bits)
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    thr = torch.as_tensor(max_width, dtype=dtype, device=dev) + _WIDTH_EPS

    def expand(lanes_wb):  # [w, b] -> [n_bits, b] bits as floats
        bits = (lanes_wb[:, None, :] >> shifts[None, :, None]) & 1
        return bits.reshape(n_bits, b).to(dtype)

    # n_big[j, b] = #over-width nodes holding bit j (exact integers).
    big = (width > thr).to(torch.int32)                       # [n, b]
    n_big = torch.cat([
        (((inds[:, word, None, :] >> shifts[None, :, None]) & 1) *
         big[:, None, :]).sum(dim=0, dtype=torch.int32)
        for word in range(w)]).to(dtype)                       # [n_bits, b]
    score = n_big * 1e6 + log2d_flat[:, None] + 1e-4 * jitter
    order = torch.argsort(-score, dim=0, stable=True)        # [n_bits, b]
    log2d_sorted = log2d_flat[order]
    skip_sorted = torch.gather(
        expand(skip_wb.reshape(w, 1).expand(w, b)), 0, order)

    def all_sw(slices):
        sliced = inds & ~slices[None]
        if uniform_log2 is not None:
            return _pc_width(sliced, uniform_log2, dtype, word_axis=1)
        return _width_nodes(sliced, log2d_w32)

    def select_at(slices, t_star, sw, active):
        xs = torch.gather(inds, 0, t_star[None, None, :].expand(1, w, b))[0]
        cand_sorted = (torch.gather(expand(xs & ~slices), 0, order) *
                       (1.0 - skip_sorted))
        removed = cand_sorted * log2d_sorted
        cum = _cumsum_blocked(removed) - removed
        w_before = sw[None, :] - cum
        selected_sorted = (cand_sorted > 0) & (w_before > thr) & \
            active[None, :]
        selected = torch.zeros((n_bits, b), dtype=torch.bool, device=dev)
        selected.scatter_(0, order, selected_sorted)
        return slices | _pack_bits(selected.reshape(w, 32, b), 1)

    # First-over node per round (output-identical to one pass over all N
    # nodes: slices only grow, so widths only shrink).
    slices = torch.zeros((w, b), dtype=torch.int32, device=dev)
    processed = torch.zeros((n, b), dtype=torch.bool, device=dev)
    iota = torch.arange(n, device=dev)[:, None]
    k_batch = 8 if uniform_log2 is not None else 1
    w_cur = all_sw(slices)
    r = 0
    while r < n and bool(((~processed) & (w_cur > thr)).any()):
        for _ in range(k_batch):
            over = (~processed) & (w_cur > thr)
            any_over = over.any(dim=0)
            t_star = over.to(torch.uint8).argmax(dim=0)       # first over
            if uniform_log2 is not None:
                xs = torch.gather(inds, 0,
                                  t_star[None, None, :].expand(1, w, b))[0]
                sw = _pc_width(xs & ~slices, uniform_log2, dtype,
                               word_axis=0)
                active = any_over & (sw > thr)
            else:
                sw = w_cur.gather(0, t_star[None])[0]
                active = any_over
            slices = select_at(slices, t_star, sw, active)
            processed |= (iota == t_star[None]) & any_over[None]
        w_cur = all_sw(slices)
        r += k_batch
    return slices


def _width_nodes(lanes_nwb, log2d_w32, chunk=64):
    """Pinned-tree width of ``[N, W, B]`` lane sets -> ``[N, B]``,
    ``chunk`` nodes at a time so the expanded-bit temporaries stay
    bounded (elementwise, so the values do not depend on the chunks)."""
    n, _, b = lanes_nwb.shape
    out = torch.empty((n, b), dtype=log2d_w32.dtype, device=lanes_nwb.device)
    for s in range(0, n, chunk):
        out[s:s + chunk] = _width_b(lanes_nwb[s:s + chunk].permute(1, 0, 2),
                                    log2d_w32)
    return out


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

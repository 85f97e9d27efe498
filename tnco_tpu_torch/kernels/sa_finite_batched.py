"""Finite-width batch state, its host initializer, the slice-aware cost,
the greedy slicers and the lockstep 'batched' engine (from
``tnco_tpu/kernels/sa_finite_batched.py``: ``SABatchFW`` :28,
``_pc_width`` :102, ``_lcc_fw_b`` :125-160, ``_greedy_slices_fast``
:163-325, ``_greedy_slices_b`` :328-508, ``_sweep_fw_batched`` :511-745,
``_run_fw`` :748-776, ``init_batch_fw`` :783-883).

Layout is the reference's replica-minor one (replica axis LAST; ``keys``
replica-first), with ``uint32`` words held as ``int32`` bit patterns.

The lockstep sweep is the infinite-memory one of
:mod:`tnco_tpu_torch.kernels.sa_batched` (a ``[F, B, N]`` plane state
whose rows are read with K1 and written with K3, here with a width
plane) with the width cap (finite_width/
greedy/optimizer.hpp:43-460): a move must fit ``max_width`` after the
replica's slices, or (``max_new_slices > 0``) be rescued by random new
slices and a whole-tree recost; every contraction is charged with the
slices; after a sweep the slice set is re-derived greedily where the
mask says so and kept only where the total improves.
"""

from dataclasses import dataclass, fields
from random import Random

import numpy as np
import torch

from tnco_tpu_torch.device import resolve_device
from tnco_tpu_torch.kernels import sa_batched as sb
from tnco_tpu_torch.kernels import sa_finite as saf
from tnco_tpu_torch.kernels import sa_infinite as sa
from tnco_tpu_torch.kernels.gather import gather_bn, gather_gbn
from tnco_tpu_torch.kernels.sa_batched import NULL, _log2_total_b, _width_b
from tnco_tpu_torch.kernels.sa_finite import (_WIDTH_EPS, _cumsum_blocked,
                                              _pack_bits, _pick_rescue_slices,
                                              greedy_slices_host)
from tnco_tpu_torch.kernels.sa_fullsweep import _join_f, _nk, _split_f
from tnco_tpu_torch.ops import costs as costs_ops
from tnco_tpu_torch.ops import rng
from tnco_tpu_torch.ops.bitops import popcount32
from tnco_tpu_torch.utils.profiling import host_read

__all__ = ['SABatchFW', 'init_batch_fw', 'from_states_fw',
           'replica_state_fw', 'run_sweeps_fw_batched',
           'run_sweeps_fw_per_replica', 'draw_sweep_fw']


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


def _pc_width(lanes, uniform_log2, dtype, word_axis, sparse_w=None,
              log2_n_projs=None):
    """Popcount width for UNIFORM index dims: ``log2(dim) * popcount``
    (bitwise-identical to the pinned pairwise tree for power-of-two
    dims).  With ``sparse_w`` (``int32 [W]``) the sparse part is capped
    at ``log2_n_projs``."""
    u = torch.tensor(uniform_log2, dtype=dtype, device=lanes.device)

    def pc(x):
        return popcount32(x).sum(dim=word_axis, dtype=torch.int32).to(dtype)

    if sparse_w is None:
        return pc(lanes) * u
    shape = [1] * lanes.dim()
    shape[word_axis] = -1
    sp = sparse_w.reshape(shape)
    return pc(lanes & ~sp) * u + torch.clamp(pc(lanes & sp) * u,
                                             max=float(log2_n_projs))


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
    max_count = host_read(over0.sum(dim=0).max(), int) if b else 0

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
    return _pack_bits(lane_bits.T, w).contiguous()


def _lcc_fw_b(c0, c1, inds, slices, log2d_w32, sparse_wb=None,
              log2_n_projs=None, uniform_log2=None):
    """``[N, B]`` slice-aware log2 cost per node (leaves -> -inf): the
    width of ``inds[c0] | inds[c1] | slices``.

    With ``uniform_log2`` the child rows are read through K1
    (:func:`gather_gbn`) and the width is the popcount times the common
    log2 dim; otherwise each node's width is the pinned tree of
    :func:`_width_b`.  ``inds: [N, W, B]`` may be a strided view.
    ``sparse_wb`` (``int32 [W]`` or ``[W, 1]``): the sparse part of each
    cost is capped at ``log2_n_projs``.
    """
    sp = sb.sparse_args(sparse_wb, log2_n_projs)
    internal = c0 != -1
    dtype = log2d_w32.dtype
    if uniform_log2 is not None:
        inds_wbn = inds.permute(1, 2, 0).contiguous()         # [W, B, N]
        ids0 = torch.where(internal, c0, -1).T.contiguous()    # [B, N]
        ids1 = torch.where(internal, c1, -1).T.contiguous()
        union = (gather_gbn(inds_wbn, ids0) | gather_gbn(inds_wbn, ids1) |
                 slices[:, :, None])                           # [W, B, N]
        lcc = _pc_width(union, uniform_log2, dtype, 0, sp['sparse_wb'],
                        sp['log2_n_projs']).T
    else:
        w = inds.shape[1]

        def rows(ids):
            ids = torch.where(internal, ids, 0).long()
            return torch.gather(inds, 0, ids[:, None, :].expand(-1, w, -1))

        lcc = _width_nodes(rows(c0) | rows(c1) | slices[None], log2d_w32,
                           sp)
    return torch.where(internal, lcc, -torch.inf).to(dtype)


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
    INTEGER log2 dims without sparse indices go to
    :func:`_greedy_slices_fast`, which gives the same slices.  With
    ``sparse_wb`` the widths cap their sparse part at ``log2_n_projs``,
    and so does the width before each candidate, whose dense and sparse
    prefixes are summed apart (``sa_finite_batched.py:425-434``).

    ``inds: [N, W, B]`` (may be a strided view), ``width: [N, B]``
    pre-slicing widths, ``jitter: [n_bits, B]`` (the caller draws it),
    ``skip_wb``: int32 ``[W]`` or ``[W, 1]`` lanes never sliced.  ``c0``
    is unused (the reference's signature).  Returns int32 ``[W, B]``.
    """
    del c0
    sp = sb.sparse_args(sparse_wb, log2_n_projs)
    sparse_w, cap = sp['sparse_wb'], sp['log2_n_projs']
    if (uniform_log2 is not None and sparse_w is None and
            float(uniform_log2).is_integer()):
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
    if sparse_w is not None:
        sparse_sorted = torch.gather(
            expand(sparse_w.reshape(w, 1).expand(w, b)), 0, order)

    def all_sw(slices):
        sliced = inds & ~slices[None]
        if uniform_log2 is not None:
            return _pc_width(sliced, uniform_log2, dtype, 1, sparse_w, cap)
        return _width_nodes(sliced, log2d_w32, sp)

    def select_at(slices, t_star, sw, active):
        xs = torch.gather(inds, 0, t_star[None, None, :].expand(1, w, b))[0]
        sliced = xs & ~slices
        cand_sorted = (torch.gather(expand(sliced), 0, order) *
                       (1.0 - skip_sorted))
        if sparse_w is None:
            removed = cand_sorted * log2d_sorted
            cum = _cumsum_blocked(removed) - removed
            w_before = sw[None, :] - cum
        else:
            dense_rm = cand_sorted * log2d_sorted * (1 - sparse_sorted)
            sp_rm = cand_sorted * log2d_sorted * sparse_sorted
            cum_d = _cumsum_blocked(dense_rm) - dense_rm
            cum_s = _cumsum_blocked(sp_rm) - sp_rm
            w_d0 = _width_b(sliced & ~sparse_w[:, None], log2d_w32)
            w_s0 = _width_b(sliced & sparse_w[:, None], log2d_w32)
            w_before = (w_d0[None, :] - cum_d +
                        torch.clamp(w_s0[None, :] - cum_s, max=cap))
        selected_sorted = (cand_sorted > 0) & (w_before > thr) & \
            active[None, :]
        selected = torch.zeros((n_bits, b), dtype=torch.bool, device=dev)
        selected.scatter_(0, order, selected_sorted)
        return slices | _pack_bits(selected, w)

    # First-over node per round (output-identical to one pass over all N
    # nodes: slices only grow, so widths only shrink).
    slices = torch.zeros((w, b), dtype=torch.int32, device=dev)
    processed = torch.zeros((n, b), dtype=torch.bool, device=dev)
    iota = torch.arange(n, device=dev)[:, None]
    k_batch = 8 if uniform_log2 is not None else 1
    w_cur = all_sw(slices)
    r = 0
    while r < n and host_read(((~processed) & (w_cur > thr)).any(), bool):
        for _ in range(k_batch):
            over = (~processed) & (w_cur > thr)
            any_over = over.any(dim=0)
            t_star = over.to(torch.uint8).argmax(dim=0)       # first over
            if uniform_log2 is not None:
                xs = torch.gather(inds, 0,
                                  t_star[None, None, :].expand(1, w, b))[0]
                sw = _pc_width(xs & ~slices, uniform_log2, dtype, 0,
                               sparse_w, cap)
                active = any_over & (sw > thr)
            else:
                sw = w_cur.gather(0, t_star[None])[0]
                active = any_over
            slices = select_at(slices, t_star, sw, active)
            processed |= (iota == t_star[None]) & any_over[None]
        w_cur = all_sw(slices)
        r += k_batch
    return slices


def _width_nodes(lanes_nwb, log2d_w32, sp, chunk=64):
    """Pinned-tree width of ``[N, W, B]`` lane sets -> ``[N, B]``,
    ``chunk`` nodes at a time so the expanded-bit temporaries stay
    bounded (elementwise, so the values do not depend on the chunks);
    ``sp``: :func:`sa_batched.sparse_args`."""
    n, _, b = lanes_nwb.shape
    out = torch.empty((n, b), dtype=log2d_w32.dtype, device=lanes_nwb.device)
    for s in range(0, n, chunk):
        out[s:s + chunk] = _width_b(lanes_nwb[s:s + chunk].permute(1, 0, 2),
                                    log2d_w32, **sp)
    return out


def init_batch_fw(ctrees, seeds, max_width, log2_dims_padded, *,
                  skip_lanes=None, sparse_lanes=None, log2_n_projs=None,
                  dtype=np.float32, device=None):
    """Builds a replica-minor finite-width batch on the host (numpy) and
    uploads it once to ``device`` (None means the card; without CUDA that
    raises, and a host run passes ``device='cpu'``).

    Initial slices come from the host greedy slicer with per-replica
    ``random.Random(seed)`` jitter, as in the JAX package, so ``c0, c1,
    par, inds, hyper, lcc, width, slices`` and the totals equal its
    ``init_batch_fw`` bitwise.  ``keys`` holds the seed words
    ``[0, seed]`` (the draws come from a ``torch.Generator``).
    ``sparse_lanes`` (``uint32 [W]``) and ``log2_n_projs``: the sparse
    cost model's cap, on the slicer's widths and every cost and width.
    """
    dev = resolve_device(device)
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
    sparse_bits = None if sparse_lanes is None else \
        expand(np.asarray(sparse_lanes, dtype=np.uint32))

    def width_of(bits):  # bool [..., n_bits] -> float64
        if sparse_bits is None:
            return bits @ log2d
        return ((bits & ~sparse_bits) @ log2d +
                np.minimum((bits & sparse_bits) @ log2d,
                           float(log2_n_projs)))

    slices = np.empty((w, b), dtype=np.uint32)
    for i in range(b):
        slices[:, i] = greedy_slices_host(
            inds[:, :, i], log2d, mw, Random(int(seeds[i]) & 0x7FFFFFFF),
            skip_bits=skip_bits, sparse_bits=sparse_bits,
            log2_n_projs=log2_n_projs)

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
        lcc[:, i] = width_of(union)
        width[:, i] = width_of(expand(inds[:, :, i]))
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
        return torch.from_numpy(x).to(dev)

    return SABatchFW(up(c0), up(c1), up(par), up(inds), up(hyper), up(lcc),
                     up(width), up(slices), up(lt), up(lt), up(c0), up(c1),
                     up(par), up(inds), up(slices), up(keys))


def from_states_fw(states) -> SABatchFW:
    """Stacks single-replica ``SAStateFW`` (all on one device) into a
    replica-minor batch on that device (``sa_finite_batched.py:72-83``)."""
    return saf.to_batch_fw(sa.stack(sb._one_device(states)))


def replica_state_fw(batch: SABatchFW, i: int):
    """Replica ``i`` of ``batch`` as an ``SAStateFW``, its fields the
    batch's column ``i`` (``sa_finite_batched.py:86-99``)."""
    return sa.unstack(saf.from_batch_fw(batch), i)


def draw_sweep_fw(generator: torch.Generator, n_leaves: int, b: int,
                  n_bits: int, reslice: bool, rescue: bool,
                  dtype=torch.float32) -> dict:
    """One FW sweep's draws: :func:`sa_batched.draw_sweep`'s streams,
    ``jitter [n_bits, B]`` for the reslice (if ``reslice``) and, for the
    rescue (if ``rescue``), ``u2 [T, B]``.  The rescue's priorities
    (``[n_bits, B]`` a step) are drawn step by step by the sweep."""
    dr = sb.draw_sweep(generator, n_leaves, b, dtype)
    if reslice:
        dr['jitter'] = rng.rand(generator, (n_bits, b), -1, dtype)
    if rescue:
        dr['u2'] = rng.rand(generator, dr['u'].shape, -1, dtype)
    return dr


def _sweep_fw(st, w, beta, update_slices, max_width, log2d_w32, skip_wb,
              cfg, dr, prio_at, uniform_log2, sp):
    """One lockstep width-capped sweep plus the reslice-if-better, in
    place on ``st`` (planes with the lcc and width planes, slices);
    returns ``(log2 total, walk steps per replica [B])``.  ``prio_at(t)``
    gives step ``t``'s rescue priorities ``[n_bits, B]``; ``sp``:
    :func:`sa_batched.sparse_args`."""
    planes, dtype = st['planes'], st['dtype']
    nk = _nk(dtype)
    lcc_planes = slice(w + sb.LCC, w + sb.LCC + nk)
    wpl = w + sb.LCC + nk                    # the width planes follow lcc's
    n_leaves = cfg.n_leaves
    thr = max_width + _WIDTH_EPS
    log2d_flat = log2d_w32.reshape(-1)

    def views(pl):
        """``(c0, c1, inds)`` ``[N, B]``, ``[N, W, B]`` views of planes."""
        return (pl[w + sb.C0].T, pl[w + sb.C1].T,
                pl[:w].permute(2, 0, 1))

    lt = sb._lt(planes, w, n_leaves, dtype)
    pos_b = sb._par_of(planes, w, dr['leaf'])
    active = (pos_b != NULL) & (sb._par_of(planes, w, pos_b) != NULL)
    moves = torch.zeros(active.shape, dtype=torch.int32,
                        device=planes.device)
    for t in range(dr['rand_bit'].shape[0]):
        if t % sb.ACTIVE_CHECK_STEPS == 0 and not bool(active.any()):
            break
        slices = st['slices']
        p = sb._propose(planes, w, pos_b, dr['rand_bit'][t],
                        cfg.disable_shared_inds, dtype)
        new_inds_b = p['new_inds_b']
        new_width_b, new_sliced_width_b, ln_b, ln_a = sb._widths(
            (new_inds_b, new_inds_b & ~slices,
             p['inds_d'] | p['inds_c'] | slices,
             new_inds_b | p['inds_e'] | slices), log2d_w32, uniform_log2,
            sp)
        p['upd'][wpl:wpl + nk, :, 1] = _split_f(new_width_b)
        fits = new_sliced_width_b <= thr
        l_new = costs_ops.new_total_log2(lt, p['l_a'], p['l_b'], ln_a, ln_b)
        accept = active & fits & sb._accept(
            cfg.prob_kind, torch.log2(dr['u'][t]), beta, l_new, lt)
        rescued = None
        if cfg.max_new_slices > 0:
            # The rescue (greedy/optimizer.hpp:226-321): random new
            # slices until B fits, then the whole proposed tree recosted
            # with them (O(N W) per move, the reference's own cost).
            cand = new_inds_b & ~slices & ~skip_wb[:, None]
            cand_slices = slices | _pick_rescue_slices(
                prio_at(t), cand, cfg.max_new_slices, new_sliced_width_b,
                max_width, log2d_flat, w)
            can_rescue = ~fits & (sb._widths(
                (new_inds_b & ~cand_slices,), log2d_w32,
                uniform_log2, sp)[0] <= thr)
            tried = planes.clone()
            sb._write(tried, torch.stack([p['a'], p['b']], 1), p['upd'],
                      active)
            # All replicas at once: per replica, sa_finite.compute_lcc_fw
            # of the proposed tree, bitwise.
            lcc_try = _lcc_fw_b(*views(tried), cand_slices, log2d_w32,
                                **sp, uniform_log2=uniform_log2)
            lt_try = _log2_total_b(lcc_try, n_leaves)
            rescued = active & can_rescue & sb._accept(
                cfg.prob_kind, torch.log2(dr['u2'][t]), beta, lt_try, lt)
            st['slices'] = torch.where(rescued, cand_slices, slices)
            l_new = torch.where(rescued, lt_try, l_new)
            accept = accept | rescued
        sb._apply(planes, w, p, accept, ln_a, ln_b)
        if rescued is not None:
            # A rescued replica takes the whole recosted lcc.
            planes[lcc_planes] = torch.where(
                rescued[:, None], _split_f(lcc_try.T), planes[lcc_planes])
        lt = torch.where(accept, l_new, lt)
        pos_b = torch.where(active, p['a'], pos_b)
        moves += active
        active = active & (pos_b != NULL) & (sb._par_of(planes, w, pos_b) !=
                                             NULL)

    if update_slices and bool((st['slices'] != 0).any()):
        c0, c1, inds = views(planes)
        width = _join_f(planes[wpl:wpl + nk], dtype).T
        new_slices = _greedy_slices_b(c0, inds, width, dr['jitter'],
                                      max_width, log2d_w32, skip_wb, **sp,
                                      uniform_log2=uniform_log2)
        new_lcc = _lcc_fw_b(c0, c1, inds, new_slices, log2d_w32, **sp,
                            uniform_log2=uniform_log2)
        better = (_log2_total_b(new_lcc, n_leaves) <
                  sb._lt(planes, w, n_leaves, dtype))
        st['slices'] = torch.where(better, new_slices, st['slices'])
        planes[lcc_planes] = torch.where(
            better[:, None], _split_f(new_lcc.T), planes[lcc_planes])
    lt = sb._lt(planes, w, n_leaves, dtype)
    sb._snapshot_min(st, lt, w)
    return lt, moves


def run_sweeps_fw_batched(batch: SABatchFW, betas, update_slices_mask,
                          max_width, log2d_w32, skip_wb, cfg, sparse_wb=None,
                          log2_n_projs=None, *, uniform_log2=None, draws=None,
                          generator=None):
    """One width-capped lockstep sweep per beta (``_run_fw``,
    ``sa_finite_batched.py:748-776``), the reslice-if-better after sweep
    ``k`` where ``update_slices_mask[k]`` and some replica holds slices
    (the reference's global condition), on the batch's device; the batch
    itself is not modified.

    ``uniform_log2`` feeds the slicer and the slice-aware cost as in the
    JAX function (the runner passes it only for integer log2 dims).
    ``sparse_wb`` (``int32 [W]`` or ``[W, 1]``) and ``log2_n_projs``:
    the sparse cost model's cap, on every cost and width.
    ``draws`` (optional): ``leaf [K, B]``, ``rand_bit``, ``u [K, T, B]``
    and ``jitter [K, n_bits, B]``, plus ``prio [K, T, n_bits, B]`` and
    ``u2 [K, T, B]`` when ``cfg.max_new_slices > 0``; without it each
    sweep draws :func:`draw_sweep_fw` from ``generator``.  After the
    chunk ``hyper`` is refreshed with K1.  Returns the new batch and
    ``{'log2_total', 'log2_min_total': [K, B], 'moves': [K]}``.
    """
    out, hist = run_sweeps_fw_per_replica(
        batch, betas, update_slices_mask, max_width, log2d_w32, skip_wb,
        cfg, sparse_wb, log2_n_projs, uniform_log2=uniform_log2,
        draws=draws, generator=generator)
    hist['moves'] = hist['moves'].sum(dim=1)
    return out, hist


def run_sweeps_fw_per_replica(batch: SABatchFW, betas, update_slices_mask,
                              max_width, log2d_w32, skip_wb, cfg,
                              sparse_wb=None, log2_n_projs=None, *,
                              uniform_log2=None, draws=None, generator=None):
    """:func:`run_sweeps_fw_batched` with the walk steps counted per
    replica: ``'moves'`` is ``int32 [K, B]`` (what the replica-major
    engine of :mod:`~tnco_tpu_torch.kernels.sa_finite` reports)."""
    sb.check_prob_kind(cfg)
    dev = batch.c0.device
    b = batch.c0.shape[1]
    dtype = batch.lcc.dtype
    n_bits = log2d_w32.numel()
    betas = torch.as_tensor(betas).to(device=dev, dtype=dtype)
    mask = np.asarray(update_slices_mask, dtype=bool).reshape(-1)
    k = betas.shape[0]
    if k == 0 or mask.shape[0] != k:
        raise ValueError('betas and update_slices_mask must hold one entry '
                         'per sweep, at least one.')
    t = sb.max_walk_steps(cfg.n_leaves)
    rescue = cfg.max_new_slices > 0
    if draws is not None:
        spec = {'leaf': ((k, b), 'int'), 'rand_bit': ((k, t, b), 'bool'),
                'u': ((k, t, b), 'float'),
                'jitter': ((k, n_bits, b), 'float')}
        if rescue:
            spec.update(prio=((k, t, n_bits, b), 'float'),
                        u2=((k, t, b), 'float'))
        sb.check_draws(draws, spec, dev)
    elif generator is None:
        raise ValueError('Pass draws= or generator=.')
    sp = sb.sparse_args(sparse_wb, log2_n_projs)
    max_width = torch.as_tensor(max_width, dtype=dtype, device=dev)
    w, st = sb._pack_state(batch, ('lcc', 'width'))
    st['slices'] = batch.slices.clone()
    st['min_slices'] = batch.min_slices.clone()
    hist = {'log2_total': [], 'log2_min_total': [], 'moves': []}
    for i in range(k):
        if draws is not None:
            dr = {name: x[i] for name, x in draws.items()}

            def prio_at(step, dr=dr):
                return dr['prio'][step]
        else:
            dr = draw_sweep_fw(generator, cfg.n_leaves, b, n_bits,
                               bool(mask[i]), rescue, dtype)

            def prio_at(step):
                return rng.rand(generator, (n_bits, b), -1, dtype)
        lt, moves = _sweep_fw(st, w, betas[i], bool(mask[i]), max_width,
                              log2d_w32, skip_wb, cfg, dr, prio_at,
                              uniform_log2, sp)
        hist['log2_total'].append(lt)
        hist['log2_min_total'].append(st['min_lt'])
        hist['moves'].append(moves)
    fields, (lcc, width) = sb._unpack_state(st, w, 2)
    out = SABatchFW(lcc=lcc, width=width, slices=st['slices'],
                    min_slices=st['min_slices'], log2_total=lt,
                    keys=batch.keys.clone(), **fields)
    return out, {name: torch.stack(v) for name, v in hist.items()}

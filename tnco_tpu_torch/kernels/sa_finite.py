"""Finite-width configuration, the greedy slicers, the per-replica
helpers of the rescue and the replica-major 'vmapped' engine (from
``tnco_tpu/kernels/sa_finite.py``: ``SweepConfigFW`` :46-52,
``SAStateFW`` :55-90, ``_wfn`` :93, ``compute_lcc_fw`` :103,
``compute_widths`` :114, ``_pack_bits`` :120, ``greedy_slices``
:127-201, ``greedy_slices_host`` :204-281, ``init_state_fw`` :284-318,
``_pick_rescue_slices`` :331-353, ``sweep_fw`` :356-522,
``run_sweeps_fw`` :525-542, ``run_sweeps_fw_batch`` :545-556).

The slicers reproduce the reference greedy slice selection
(finite_width/greedy/utils.hpp:24-125): indices ranked by how many
over-width tensors contain them (then larger log2 dim, then random
jitter), and per node the top-ranked candidates are sliced until the node
fits ``max_width``.

The 'vmapped' engine is the lockstep one in replica-major layout, as in
:mod:`~tnco_tpu_torch.kernels.sa_infinite`: :func:`run_sweeps_fw_batch`
maps the stacked :class:`SAStateFW` onto the lockstep batch, runs
:func:`~tnco_tpu_torch.kernels.sa_finite_batched.
run_sweeps_fw_per_replica` (K1 and K3 on the card; the rescue and the
reslice-if-better included) and maps the result back.  The JAX package
holds its vmapped ``sweep_fw`` and its lockstep sweep to one trajectory
(``tnco_tpu/kernels/sa_finite_batched.py:1-8``).
"""

from dataclasses import dataclass, fields

import numpy as np
import torch

from tnco_tpu_torch.device import resolve_device
from tnco_tpu_torch.ops import bitops
from tnco_tpu_torch.ops import costs as costs_ops
from tnco_tpu_torch.ops.bitops import expand_bits

__all__ = ['SweepConfigFW', 'SAStateFW', 'init_state_fw', 'sweep_fw',
           'run_sweeps_fw', 'run_sweeps_fw_batch', 'greedy_slices',
           'greedy_slices_host', 'compute_lcc_fw', 'compute_widths',
           'from_batch_fw', 'to_batch_fw', 'NULL']

NULL = -1
_WIDTH_EPS = 1e-4  # f32 slack on width comparisons


@dataclass(frozen=True)
class SweepConfigFW:
    n_leaves: int
    n_lanes: int
    disable_shared_inds: bool = False
    prob_kind: str = 'mh'
    max_new_slices: int = 0


@dataclass
class SAStateFW:
    """Replica-major finite-width state: :class:`~tnco_tpu_torch.kernels.
    sa_infinite.SAStateIM`'s fields plus ``width: float [N]``
    (pre-slicing widths) and ``slices/min_slices: int32 [W]`` (the
    reference's width cache and slice sets, greedy/optimizer.hpp:61-70).
    A stack of replicas has a leading replica axis on every field."""
    nodes: torch.Tensor
    inds: torch.Tensor
    hyper: torch.Tensor
    lcc: torch.Tensor
    width: torch.Tensor
    slices: torch.Tensor
    log2_total: torch.Tensor
    min_log2_total: torch.Tensor
    min_nodes: torch.Tensor
    min_inds: torch.Tensor
    min_slices: torch.Tensor
    key: torch.Tensor

    @classmethod
    def field_names(cls):
        return tuple(f.name for f in fields(cls))


def _wfn(lanes, log2d, sparse_lanes=None, log2_n_projs=None):
    """Width of an index set == its log2 cost (finite_width/cost_model/
    simple.hpp:38-57; sparse part capped, simple_sparse_inds.hpp:
    38-51)."""
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


def compute_widths(inds, log2d, sparse_lanes=None, log2_n_projs=None):
    """Pre-slicing width per node (WidthCache, finite_width/utils.hpp:
    47-72)."""
    return _wfn(inds, log2d, sparse_lanes, log2_n_projs)


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
    # A node whose width fits at entry never takes a slice (slices only
    # grow, so its width only shrinks); the margin covers the sum order
    # of the product above against the per-node sums below.
    for t in np.flatnonzero(width > max_width + _WIDTH_EPS - 1e-9):
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


def greedy_slices(nodes, inds, width, jitter, max_width, log2d, skip_lanes,
                  cfg: SweepConfigFW, sparse_lanes=None, log2_n_projs=None,
                  init_slices=None):
    """Greedy slice set of one replica so every tensor fits
    ``max_width`` (``sa_finite.py:127-201``; greedy/utils.hpp:24-125).

    Bits are ranked once by ``n_big * 1e6 + log2 dim + 1e-4 * jitter``
    (``n_big``: over-width nodes, by ``width``, holding the bit; a
    STABLE argsort, as ``jnp.argsort`` is); then node by node, in node
    order, every candidate bit (in rank order, not in ``skip_lanes``) is
    sliced while the node's width before it is over the cap.  A node
    whose sliced width fits at entry never takes a slice (slices only
    grow), so only those over the cap at entry are visited.

    ``nodes: int32 [N, 3]`` (unused, the reference's signature),
    ``inds: int32 [N, W]``, ``width: [N]``, ``jitter: [W * 32]`` (the
    JAX package draws it from the replica's key), ``log2d: [W * 32]``,
    ``skip_lanes: int32 [W]``.  Returns ``int32 [W]``.
    """
    del nodes
    dev = inds.device
    n_lanes = cfg.n_lanes
    n_bits = n_lanes * 32
    dtype = log2d.dtype
    thr = torch.as_tensor(max_width, dtype=dtype, device=dev) + _WIDTH_EPS
    sp = bitops.as_lanes(sparse_lanes, dev)

    bits = expand_bits(inds, torch.int32)                      # [N, I]
    n_big = ((width > thr).to(torch.int32)[:, None] * bits).sum(
        dim=0, dtype=torch.int32).to(dtype)
    score = n_big * 1e6 + log2d + 1e-4 * jitter.to(dtype)
    order = torch.argsort(-score, stable=True)
    log2d_sorted = log2d[order]
    skip_sorted = expand_bits(skip_lanes.reshape(-1), dtype)[order]
    if sp is not None:
        sparse_sorted = expand_bits(sp, dtype)[order]
        cap = float(log2_n_projs)

    slices = (torch.zeros(n_lanes, dtype=torch.int32, device=dev)
              if init_slices is None else
              bitops.as_lanes(init_slices, dev).clone())
    sw0 = _wfn(inds & ~slices, log2d, sp, log2_n_projs)
    for t in torch.nonzero(sw0 > thr).reshape(-1).tolist():
        sliced = inds[t] & ~slices
        sw = _wfn(sliced, log2d, sp, log2_n_projs)
        cand_sorted = expand_bits(sliced, dtype)[order] * (1.0 - skip_sorted)
        if sp is None:
            removed = cand_sorted * log2d_sorted
            w_before = sw - (_cumsum_blocked(removed) - removed)
        else:
            dense_rm = cand_sorted * log2d_sorted * (1 - sparse_sorted)
            sp_rm = cand_sorted * log2d_sorted * sparse_sorted
            cum_d = _cumsum_blocked(dense_rm) - dense_rm
            cum_s = _cumsum_blocked(sp_rm) - sp_rm
            w_d0 = _wfn(sliced & ~sp, log2d)
            w_s0 = _wfn(sliced & sp, log2d)
            w_before = w_d0 - cum_d + torch.clamp(w_s0 - cum_s, max=cap)
        selected_sorted = (cand_sorted > 0) & (w_before > thr) & (sw > thr)
        selected = torch.zeros(n_bits, dtype=torch.bool, device=dev)
        selected[order] = selected_sorted
        slices = slices | _pack_bits(selected, n_lanes)
    return slices


def init_state_fw(ctree, seed, max_width, log2_dims_padded=None, *,
                  skip_lanes=None, sparse_lanes=None, log2_n_projs=None,
                  slices=None, dtype=torch.float32, jitter=None,
                  device=None) -> SAStateFW:
    """The state of one replica from a host tree, on ``device`` (None
    means the card), with the initial slices of :func:`greedy_slices`
    unless ``slices`` is given (the reference constructor,
    greedy/optimizer.hpp:85-97).  ``jitter [W * 32]``: the slicer's
    jitter (the JAX package draws it from ``split(PRNGKey(seed))[1]``);
    without it, from a ``torch.Generator`` seeded with ``seed``."""
    from tnco_tpu_torch.kernels import sa_infinite as sa

    dev = resolve_device(device)
    nodes = torch.from_numpy(np.ascontiguousarray(
        ctree.nodes_array, dtype=np.int32)).to(dev)
    inds = bitops.as_lanes(ctree.inds_array, dev)
    n_lanes = inds.shape[1]
    if log2_dims_padded is None:
        log2_dims_padded = bitops.pad_log2_dims(ctree.log2_dims_array,
                                                n_lanes, dtype, dev)
    log2d = torch.as_tensor(log2_dims_padded, dtype=dtype, device=dev)
    skip = (torch.zeros(n_lanes, dtype=torch.int32, device=dev)
            if skip_lanes is None else bitops.as_lanes(skip_lanes, dev))
    sp = bitops.as_lanes(sparse_lanes, dev)
    width = compute_widths(inds, log2d, sp, log2_n_projs)
    if slices is None:
        if jitter is None:
            gen = torch.Generator(device=dev).manual_seed(int(seed))
            jitter = torch.rand(n_lanes * 32, generator=gen, device=dev,
                                dtype=dtype)
        cfg = SweepConfigFW(n_leaves=ctree.n_leaves, n_lanes=n_lanes)
        slices = greedy_slices(nodes, inds, width, jitter.to(dev), max_width,
                               log2d, skip, cfg, sp, log2_n_projs)
    else:
        slices = bitops.as_lanes(slices, dev)
    hyper = sa.compute_hyper(nodes, inds)
    lcc = compute_lcc_fw(nodes, inds, slices, log2d, sp, log2_n_projs)
    lt = costs_ops.log2_total_from_lcc(lcc, ctree.n_leaves)
    return SAStateFW(nodes, inds, hyper, lcc, width, slices, lt, lt.clone(),
                     nodes.clone(), inds.clone(), slices.clone(),
                     sa.seed_key(seed).to(dev))


def from_batch_fw(batch) -> SAStateFW:
    """Lane-major ``SABatchFW`` -> stacked replica-major state
    (``replicas.py:73-82``)."""
    from tnco_tpu_torch.kernels import sa_infinite as sa

    im = sa.from_batch(batch)
    return SAStateFW(im.nodes, im.inds, im.hyper, im.lcc,
                     batch.width.T.contiguous(), batch.slices.T.contiguous(),
                     im.log2_total, im.min_log2_total, im.min_nodes,
                     im.min_inds, batch.min_slices.T.contiguous(), im.key)


def to_batch_fw(states: SAStateFW):
    """Inverse of :func:`from_batch_fw`."""
    from tnco_tpu_torch.kernels import sa_infinite as sa
    from tnco_tpu_torch.kernels.sa_finite_batched import SABatchFW

    s = states
    im = sa.to_batch(sa.SAStateIM(s.nodes, s.inds, s.hyper, s.lcc,
                                  s.log2_total, s.min_log2_total,
                                  s.min_nodes, s.min_inds, s.key))
    return SABatchFW(im.c0, im.c1, im.par, im.inds, im.hyper, im.lcc,
                     s.width.T.contiguous(), s.slices.T.contiguous(),
                     im.log2_total, im.min_log2_total, im.min_c0, im.min_c1,
                     im.min_par, im.min_inds, s.min_slices.T.contiguous(),
                     im.keys)


def run_sweeps_fw_batch(states: SAStateFW, betas, update_slices_mask,
                        max_width, log2d, skip_lanes, cfg: SweepConfigFW,
                        sparse_lanes=None, log2_n_projs=None, *,
                        uniform_log2=None, draws=None, generator=None):
    """One width-capped sweep per beta for every replica of a stacked
    state (the JAX package's ``vmap`` of ``run_sweeps_fw``), the
    reslice-if-better after sweep ``k`` where ``update_slices_mask[k]``
    (host booleans), on the state's device.

    ``log2d: [W * 32]``, ``skip_lanes: int32 [W]``; ``sparse_lanes``,
    ``log2_n_projs``: the sparse cost model's cap, or None.
    ``uniform_log2``: the common log2 dim on integer log2 dims (popcount
    widths and, without sparse indices, the plane slicer, bitwise equal
    to the reference path there), or None.  ``draws``/``generator``: as
    for :func:`~tnco_tpu_torch.kernels.sa_finite_batched.
    run_sweeps_fw_batched`.  Returns the new state and
    ``{'log2_total', 'log2_min_total', 'moves'}``, each ``[B, K]``; the
    input is not modified.
    """
    from tnco_tpu_torch.kernels import sa_finite_batched as sfb

    batch = to_batch_fw(states)
    dev = batch.c0.device
    w = batch.inds.shape[1]
    log2d_w32 = torch.as_tensor(log2d, device=dev).reshape(w, 32)
    out, hist = sfb.run_sweeps_fw_per_replica(
        batch, betas, update_slices_mask, max_width, log2d_w32,
        bitops.as_lanes(skip_lanes, dev).reshape(-1), cfg,
        bitops.as_lanes(sparse_lanes, dev), log2_n_projs,
        uniform_log2=uniform_log2, draws=draws, generator=generator)
    return from_batch_fw(out), {k: v.T.contiguous()
                                for k, v in hist.items()}


def run_sweeps_fw(state: SAStateFW, betas, update_slices_mask, max_width,
                  log2d, skip_lanes, cfg: SweepConfigFW, sparse_lanes=None,
                  log2_n_projs=None, *, uniform_log2=None, draws=None,
                  generator=None):
    """:func:`run_sweeps_fw_batch` of one replica (``draws`` with ``B =
    1``); metrics ``[K]``."""
    from tnco_tpu_torch.kernels import sa_infinite as sa

    out, hist = run_sweeps_fw_batch(
        sa.stack([state]), betas, update_slices_mask, max_width, log2d,
        skip_lanes, cfg, sparse_lanes, log2_n_projs,
        uniform_log2=uniform_log2, draws=draws, generator=generator)
    return sa.unstack(out, 0), {k: v[0] for k, v in hist.items()}


def sweep_fw(state: SAStateFW, beta, update_slices, max_width, log2d,
             skip_lanes, cfg: SweepConfigFW, sparse_lanes=None,
             log2_n_projs=None, *, uniform_log2=None, draws=None,
             generator=None):
    """One width-capped leaf-to-root sweep of one replica plus the
    reslice-if-better if ``update_slices``: :func:`run_sweeps_fw` at one
    beta.  Returns ``(state, moves)``."""
    out, hist = run_sweeps_fw(state, [float(beta)], [bool(update_slices)],
                              max_width, log2d, skip_lanes, cfg,
                              sparse_lanes, log2_n_projs,
                              uniform_log2=uniform_log2, draws=draws,
                              generator=generator)
    return out, hist['moves'][0]

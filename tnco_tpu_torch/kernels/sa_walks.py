"""Chained multi-walk SA engines, infinite memory and finite width (the
port of ``tnco_tpu/kernels/sa_walks.py``: ``run_walks`` :488-580,
``run_walks_fw`` :583-800 and their helpers).

Each iteration, ``P`` walks per replica propose an uncle swap at their
current node (the reference move, include/tnco/optimize/infinite_memory/
optimizer.hpp:117-192, with the width cap of finite_width/greedy/
optimizer.hpp:188-225 in finite width), are accepted against the
pre-round total, a pairwise-disjoint set is kept (lower walk index
wins), the kept moves are applied and the walks advance; finite width
re-derives the slice set greedily every ``update_slices`` iterations and
keeps it where the total improves.

State is ``int32 [F, B, N_pad]`` planes of bit patterns with nodes last:
``[0:W)`` index words, (FW plane slicer) ``[W:2W)`` union planes ``U[i]
= inds[c0[i]] | inds[c1[i]]`` maintained by the apply, c0, c1, lcc, (FW)
the pre-slicing width, par; each float row takes ``nk`` planes (one for
float32, two for float64, ``sa_fullsweep._split_f``).  Every irregular
row access goes through the hand-written kernels: row reads through K1
(:func:`~tnco_tpu_torch.kernels.gather.gather_gbn`), the two apply
scatters through K3 (:func:`~tnco_tpu_torch.kernels.scatter.
scatter_rows_inplace`, one launch that resolves duplicate ids itself),
which writes the state IN PLACE where the JAX engine donated its buffer.

The options are the JAX engines': ``claim`` 'sequential' (the
multi-walk engine's scan: lower index wins against lower-index KEPT
walks) or 'pairwise' (one pass: against every lower-index ACCEPTED
walk), ``on_block`` 'advance', 'restart' or 'dedup' and
``accept_rule`` 'round' or 'chained' (both shared with
:mod:`~tnco_tpu_torch.kernels.sa_multiwalk`, so the two engines are
bitwise equal under the sequential claim), ``prob_kind`` 'mh',
'mh_local', 'greedy' or 'base', float32 or float64 state, sparse
indices, and (finite width) both slicers: the plane slicer on uniform
power-of-two dims without sparse indices and the reference-shaped one
(``slicer='ref'``, sparse indices and every other dims table: no union
planes, the reslice unpacks the state).  Semantics follow the JAX
engines operation by operation, so integer state and slices are bitwise
equal on the same state and draws, and totals agree within the float
bound of ``exp2``/``log2`` (tests inject the JAX draws through
``draws=``).
"""

import numpy as np
import torch

from tnco_tpu_torch.device import resolve_device
from tnco_tpu_torch.kernels import sa_multiwalk as smw
from tnco_tpu_torch.kernels.gather import gather_gbn
from tnco_tpu_torch.kernels.sa_batched import (SABatch, compute_hyper_b,
                                               sparse_args)
from tnco_tpu_torch.kernels.sa_finite import _WIDTH_EPS
from tnco_tpu_torch.kernels.sa_finite_batched import (SABatchFW,
                                                      _greedy_slices_b,
                                                      _greedy_slices_fast,
                                                      _lcc_fw_b, _pc_width)
from tnco_tpu_torch.kernels.sa_fullsweep import (_join_f, _nk, _split_f,
                                                 _width_bn)
from tnco_tpu_torch.kernels.sa_infinite import SweepConfig
from tnco_tpu_torch.kernels.sa_multiwalk import _chains_lt, draw_walks
# The walks engines' sequential claim is the multi-walk engine's.
from tnco_tpu_torch.kernels.sa_multiwalk import \
    _claim_disjoint as _claim_sequential
from tnco_tpu_torch.kernels.scatter import scatter_rows_inplace
from tnco_tpu_torch.ops import costs as costs_ops
from tnco_tpu_torch.utils.profiling import host_read, span

__all__ = ['run_walks', 'run_walks_fw']

NULL = -1
_CLAIMS = ('sequential', 'pairwise')
_PROB_KINDS = ('mh', 'mh_local', 'greedy', 'base')
_SCALED_FLOOR = 2.0**-60


def _n_pad(n: int) -> int:
    """Node-axis padding to a multiple of 128 (inert rows)."""
    return -(-n // 128) * 128


def _pack_w(c0, c1, par, inds, lcc, width=None):
    """``[N, B]`` / ``[N, W, B]`` tensors -> ``int32 [F, B, N_pad]``.

    Plane layout: ``[0:W)`` inds; c0; c1; lcc; optionally the FW
    pre-slicing width; par LAST.  Padding rows are inert: children and
    parent NULL, inds 0, lcc -inf (an exact zero in the pinned total).
    """
    n = c0.shape[0]
    pad = _n_pad(n) - n
    if pad:
        def cat(x, fill):
            return torch.cat([x, x.new_full((pad,) + x.shape[1:], fill)])
        c0, c1, par = cat(c0, NULL), cat(c1, NULL), cat(par, NULL)
        inds = cat(inds, 0)
        lcc = cat(lcc, -torch.inf)
        if width is not None:
            width = cat(width, 0)
    planes = [inds.permute(1, 2, 0), c0.T[None], c1.T[None],
              _split_f(lcc.T.contiguous())]
    if width is not None:
        planes.append(_split_f(width.T.contiguous()))
    planes.append(par.T[None])
    return torch.cat(planes, dim=0).contiguous()


def _par_plane(w, nk, fw, u=0):
    """Index of the par plane (``u`` = union-plane count)."""
    return w + u + 2 + nk + (nk if fw else 0)


def _unpack_w(S, w, dtype, n, fw=False, u=0):
    nk = _nk(dtype)
    inds = S[:w, :, :n].permute(2, 0, 1).contiguous()       # [N, W, B]
    c0 = S[w + u, :, :n].T.contiguous()
    c1 = S[w + u + 1, :, :n].T.contiguous()
    lcc = _join_f(S[w + u + 2:w + u + 2 + nk, :, :n], dtype).T.contiguous()
    par = S[_par_plane(w, nk, fw, u), :, :n].T.contiguous()
    if not fw:
        return c0, c1, par, inds, lcc
    width = _join_f(S[w + u + 2 + nk:w + u + 2 + 2 * nk, :, :n],
                    dtype).T.contiguous()
    return c0, c1, par, inds, lcc, width


def _lt_from_S(S, w, nk, nl, dtype, u=0):
    lcc_bn = _join_f(S[w + u + 2:w + u + 2 + nk], dtype)    # [B, N]
    return costs_ops.log2_total_from_lcc_last(lcc_bn, nl)


def _propose_walks(S, pos, leaf, rand_bit, cfg: SweepConfig, log2d_w32,
                   uniform_log2, dtype, slices_wb=None, with_width=False,
                   u=0, sp=None):
    """Row pulls + proposal math at the ``[B, P]`` walk positions.

    Three dependent pull phases through K1 (par at the positions and
    fresh leaves; scalar rows at B; scalar rows at A), then ONE
    index-plane gather at the five ids {B, A, C, c0(B), c1(B)}.  Returns
    the advanced positions and the per-walk ``ev`` dict (ids/costs
    ``[B, P]``, lane sets ``[W, B, P]``).  ``sp``: the sparse cost
    model's ``{'sparse_w', 'log2_n_projs'}`` (None: dense).
    """
    sp = sp or {}
    w = cfg.n_lanes
    nk = _nk(dtype)
    p = pos.shape[1]
    par_plane = _par_plane(w, nk, with_width, u)

    # Restart finished walks at the parent of a fresh leaf.
    ids0 = torch.cat([pos.clamp(min=0), leaf], dim=1)
    pp = gather_gbn(S, ids0, planes=(par_plane, par_plane + 1))[0]
    par_pos, par_leaf = pp[:, :p], pp[:, p:]
    at_boundary = (pos == NULL) | (par_pos == NULL)
    pos = torch.where(at_boundary, par_leaf, pos).contiguous()

    b = pos
    rb = gather_gbn(S, b, planes=(w + u, par_plane + 1))
    c0b, c1b = rb[0], rb[1]
    l_b = _join_f(rb[2:2 + nk], dtype)
    a = torch.where(b == NULL, NULL, rb[-1]).contiguous()
    ev = dict(a=a, b=b, c0b=c0b, c1b=c1b, l_b=l_b)
    if with_width:
        ev['w_b'] = _join_f(rb[2 + nk:2 + 2 * nk], dtype)

    ra = gather_gbn(S, a, planes=(w + u, par_plane))
    c0a, c1a = ra[0], ra[1]
    ev['l_a'] = _join_f(ra[2:2 + nk], dtype)
    if with_width:
        ev['w_a'] = _join_f(ra[2 + nk:2 + 2 * nk], dtype)
    c = torch.where(c0a == b, c1a, c0a)
    ev.update(c=c, c0a=c0a, c1a=c1a)

    r5 = gather_gbn(S, torch.cat([b, a, c, c0b, c1b], dim=1),
                    planes=(0, w))
    inds_b = r5[:, :, :p]
    inds_a = r5[:, :, p:2 * p]
    inds_c = r5[:, :, 2 * p:3 * p]
    inds0 = r5[:, :, 3 * p:4 * p]
    inds1 = r5[:, :, 4 * p:]
    ev['inds_b'] = inds_b
    ev['inds_a'] = inds_a

    i0 = ((inds0 & inds_c) != 0).any(dim=0)
    i1 = ((inds1 & inds_c) != 0).any(dim=0)
    take0 = rand_bit if cfg.disable_shared_inds else \
        torch.where(i0 & i1, rand_bit, i0)
    ev['d'] = torch.where(take0, c0b, c1b)
    ev['e'] = torch.where(take0, c1b, c0b)
    t0 = take0[None]
    inds_d = torch.where(t0, inds0, inds1)
    inds_e = torch.where(t0, inds1, inds0)
    if with_width:
        # The FW apply maintains the union planes from these.
        ev['inds_c'] = inds_c
        ev['inds_d'] = inds_d

    hyp_a = inds_a & inds_b & inds_c
    hyp_b = inds_b & inds0 & inds1
    ev['new_inds_b'] = (inds_d ^ inds_c) | hyp_a | hyp_b

    def width(lanes):
        if slices_wb is not None:
            lanes = lanes | slices_wb[:, :, None]
        return _width_bn(lanes, log2d_w32, uniform_log2, dtype, **sp)

    ev['ln_b'] = width(inds_d | inds_c)
    ev['ln_a'] = width(ev['new_inds_b'] | inds_e)
    ev['inds_e'] = inds_e
    return pos, ev


def _accept_walks(ev, lt, u, beta, prob_kind='mh'):
    """The acceptance of every walk against the pre-round total
    (``sa_walks.py:244-272``); ``beta`` is a 0-dim tensor or ``[B]``
    (one temperature per replica).  'mh': Metropolis on the totals
    ratio; 'mh_local': Metropolis on the ratio of the two touched
    contractions' costs (every cost scale of the tree anneals at once);
    'greedy': no worse total; 'base': every proposal.  Root-adjacent
    walks (no uncle) only advance."""
    if beta.ndim:
        beta = beta[:, None]
    if prob_kind in ('mh', 'greedy'):
        l_new = costs_ops.new_total_log2(lt[:, None], ev['l_a'], ev['l_b'],
                                         ev['ln_a'], ev['ln_b'])
        if prob_kind == 'mh':
            accept = torch.log2(u) <= -beta * (l_new - lt[:, None])
        else:
            accept = l_new <= lt[:, None]
    elif prob_kind == 'mh_local':
        m = torch.maximum(torch.maximum(ev['l_a'], ev['l_b']),
                          torch.maximum(ev['ln_a'], ev['ln_b']))
        old = torch.exp2(ev['l_a'] - m) + torch.exp2(ev['l_b'] - m)
        new = torch.exp2(ev['ln_a'] - m) + torch.exp2(ev['ln_b'] - m)
        delta = (torch.log2(torch.clamp(new, min=_SCALED_FLOOR)) -
                 torch.log2(torch.clamp(old, min=_SCALED_FLOOR)))
        accept = torch.log2(u) <= -beta * delta
    else:
        accept = torch.ones_like(ev['l_a'], dtype=torch.bool)
    return accept & (ev['b'] != NULL) & (ev['a'] != NULL)


def _claim_pairwise(accept, ev):
    """Lower walk index wins against every lower-index ACCEPTED walk
    (``sa_walks.py:275-289``): one pass over the ``[B, P, P]`` conflict
    matrix, no walk loop.  More conservative than the sequential scan,
    and the kept walks are still pairwise disjoint."""
    confl = smw._conflicts(ev)                                # [B, P, Q]
    p = accept.shape[1]
    idx = torch.arange(p, device=accept.device)
    lower = idx[None, :] < idx[:, None]                       # q < p
    blocked = (confl & accept[:, None, :] & lower[None]).any(dim=2)
    return accept & ~blocked


def _claims(cfg, ev, lt, u, beta, claim, accept_rule, fits=None):
    """Acceptance and claims of one iteration (``sa_walks.py:507-514,
    620-627``): the chained scan (:func:`sa_multiwalk._claim_chained`,
    the sequential scan of both engines) where ``accept_rule='chained'``
    changes anything, else :func:`_accept_walks` and ``claim``.
    ``fits``: the FW width cap per walk, or None.  Returns ``(accept,
    keep)`` ``[B, P]``."""
    if accept_rule == 'chained' and _chains_lt(cfg):
        valid = (ev['b'] != NULL) & (ev['a'] != NULL)
        if fits is not None:
            valid = valid & fits
        return smw._claim_chained(cfg, u, beta, lt, valid, ev)
    accept = _accept_walks(ev, lt, u, beta, cfg.prob_kind)
    if fits is not None:
        accept = accept & fits
    keep = (_claim_sequential if claim == 'sequential' else
            _claim_pairwise)(accept, ev)
    return accept, keep


def _apply_walks(S, ev, kept, cfg: SweepConfig, dtype, with_width=False,
                 u=0):
    """Scatter the 4 touched rows of every kept walk, IN PLACE on ``S``.

    TWO plane-range scatters (K3): the merged group (inds, the
    union planes, c0, c1, lcc and the width) at the {B, A} ids, and the
    par plane at the {C, E} ids.  Float rows are written in the additive
    form ``old + (new - old)`` of the JAX engine.
    """
    w = cfg.n_lanes
    nk = _nk(dtype)
    par_plane = _par_plane(w, nk, with_width, u)

    def masked(ids):
        return torch.where(kept, ids, NULL)

    b_k, a_k = masked(ev['b']), masked(ev['a'])
    c_k, e_k = masked(ev['c']), masked(ev['e'])

    new_c0b = torch.where(ev['c0b'] == ev['e'], ev['c'], ev['c0b'])
    new_c1b = torch.where(ev['c1b'] == ev['e'], ev['c'], ev['c1b'])
    new_c0a = torch.where(ev['c0a'] == ev['c'], ev['e'], ev['c0a'])
    new_c1a = torch.where(ev['c1a'] == ev['c'], ev['e'], ev['c1a'])
    new_l_b = ev['l_b'] + (ev['ln_b'] - ev['l_b'])
    new_l_a = ev['l_a'] + (ev['ln_a'] - ev['l_a'])

    ids_ba = torch.cat([b_k, a_k], dim=1)
    planes1 = [torch.cat([ev['new_inds_b'], ev['inds_a']], dim=2)]
    if u:
        planes1.append(torch.cat(
            [ev['inds_d'] | ev['inds_c'],
             ev['new_inds_b'] | ev['inds_e']], dim=2))
    planes1 += [
        torch.cat([new_c0b, new_c0a], dim=1)[None],
        torch.cat([new_c1b, new_c1a], dim=1)[None],
        _split_f(torch.cat([new_l_b, new_l_a], dim=1)),
    ]
    if with_width:
        new_w_b = ev['w_b'] + (ev['new_width_b'] - ev['w_b'])
        planes1.append(_split_f(torch.cat([new_w_b, ev['w_a']], dim=1)))
    upd1 = torch.cat(planes1, dim=0).contiguous()
    scatter_rows_inplace(S, ids_ba, upd1, planes=(0, par_plane))

    # par at {C, E} (C reparents to B, E to A).
    ids_ce = torch.cat([c_k, e_k], dim=1)
    upd2 = torch.cat([ev['b'], ev['a']], dim=1)[None].contiguous()
    scatter_rows_inplace(S, ids_ce, upd2,
                         planes=(par_plane, par_plane + 1))
    return S


def _reslice(S, slices, lt_post, jitter, thr_width, log2d_w32, skip_w,
             cfg, uniform_log2, dtype, up, sp):
    """Reslice-if-better on the packed state (``sa_walks.py:637-685``).

    With union planes (``up = W``, the plane slicer) the sorted-space
    slicer reads the index planes in place and lcc is one popcount pass
    over the union planes.  Without them (``up = 0``, ``slicer='ref'``)
    the state is unpacked on its padded node axis (pad rows are inert
    leaves) and the reference-shaped slicer and slice-aware cost run on
    it.  Replicas whose new total is lower take the new slices and lcc
    (written into ``S`` in place)."""
    w = cfg.n_lanes
    nk = _nk(dtype)
    if up:
        width_nb = _join_f(S[w + up + 2 + nk:w + up + 2 + 2 * nk], dtype).T
        new_slices = _greedy_slices_fast(S, (0, w), width_nb, jitter,
                                         thr_width, log2d_w32, skip_w,
                                         uniform_log2)
        internal = S[w + up] != NULL                         # [B, N]
        union = S[w:w + up] | new_slices[:, :, None]
        lcc_bn = _pc_width(union, uniform_log2, dtype, word_axis=0)
        new_lcc_bn = torch.where(internal, lcc_bn, -torch.inf).to(dtype)
    else:
        c0, c1, _par, inds, _lcc, width = _unpack_w(S, w, dtype, S.shape[2],
                                                    fw=True, u=up)
        new_slices = _greedy_slices_b(c0, inds, width, jitter, thr_width,
                                      log2d_w32, skip_w, sp['sparse_w'],
                                      sp['log2_n_projs'],
                                      uniform_log2=uniform_log2)
        new_lcc_bn = _lcc_fw_b(c0, c1, inds, new_slices, log2d_w32,
                               sp['sparse_w'], sp['log2_n_projs'],
                               uniform_log2=uniform_log2).T
    new_lt = costs_ops.log2_total_from_lcc_last(new_lcc_bn, cfg.n_leaves)
    better = new_lt < lt_post
    slices = torch.where(better[None, :], new_slices, slices)
    lcc_planes = S[w + up + 2:w + up + 2 + nk]
    lcc_cur = _join_f(lcc_planes, dtype)
    lcc_planes.copy_(_split_f(torch.where(better[:, None], new_lcc_bn,
                                          lcc_cur)))
    return slices, torch.where(better, new_lt, lt_post)


def _snapshot(st, lt_new, slices=None):
    """Min tracking: replicas whose total is strictly below their min
    take the packed state (and, finite width, the slices) as their
    min."""
    improved = lt_new < st['min_lt']
    st['min_lt'] = torch.where(improved, lt_new, st['min_lt'])
    st['S_min'] = torch.where(improved[None, :, None], st['S'], st['S_min'])
    if slices is not None:
        st['min_slices'] = torch.where(improved[None, :], slices,
                                       st['min_slices'])


def _iter_walks(st, beta, log2d_w32, cfg: SweepConfig, uniform_log2, dr,
                sp, opts):
    """One infinite-memory iteration on the state dict ``st`` (updated
    in place; ``sa_walks.py:488-528``); ``opts``: ``claim``,
    ``on_block`` and ``accept_rule``; ``sp`` as in
    :func:`_propose_walks`."""
    S = st['S']
    w = cfg.n_lanes
    dtype = log2d_w32.dtype
    with span('tnco.walks.propose'):
        pos, ev = _propose_walks(S, st['pos'], dr['leaf'], dr['rand_bit'],
                                 cfg, log2d_w32, uniform_log2, dtype, sp=sp)
    with span('tnco.walks.claim'):
        accept, keep = _claims(cfg, ev, st['lt'], dr['u'], beta,
                               opts['claim'], opts['accept_rule'])
    with span('tnco.walks.apply'):
        _apply_walks(S, ev, keep, cfg, dtype)
        st['pos'] = smw._advance_walks(ev['a'], accept, keep,
                                       opts['on_block'])
        st['moves'] += pos.numel()
        st['applied'] = st['applied'] + keep.sum(dtype=torch.int64)
        st['lt'] = _lt_from_S(S, w, _nk(dtype), cfg.n_leaves, dtype)
    _snapshot(st, st['lt'])


def _iter_walks_fw(st, beta, update_slices, max_width, log2d_w32, skip_w,
                   cfg: SweepConfig, uniform_log2, dr, up, sp, opts):
    """One iteration on the state dict ``st`` (updated in place); ``up``
    is the union-plane count of ``S`` (``W`` for the plane slicer, else
    0); ``sp`` as in :func:`_propose_walks`; ``opts`` as in
    :func:`_iter_walks`."""
    S = st['S']
    w = cfg.n_lanes
    dtype = log2d_w32.dtype
    nk = _nk(dtype)
    slices = st['slices']

    with span('tnco.walks.propose'):
        pos, ev = _propose_walks(S, st['pos'], dr['leaf'], dr['rand_bit'],
                                 cfg, log2d_w32, uniform_log2, dtype,
                                 slices_wb=slices, with_width=True, u=up,
                                 sp=sp)
        ev['new_width_b'] = _width_bn(ev['new_inds_b'], log2d_w32,
                                      uniform_log2, dtype, **sp)
        new_sliced_width = _width_bn(ev['new_inds_b'] & ~slices[:, :, None],
                                     log2d_w32, uniform_log2, dtype, **sp)
        fits = new_sliced_width <= max_width + _WIDTH_EPS
    with span('tnco.walks.claim'):
        accept, keep = _claims(cfg, ev, st['lt'], dr['u'], beta,
                               opts['claim'], opts['accept_rule'], fits)
    with span('tnco.walks.apply'):
        _apply_walks(S, ev, keep, cfg, dtype, with_width=True, u=up)
        st['pos'] = smw._advance_walks(ev['a'], accept, keep,
                                       opts['on_block'])
        st['moves'] += pos.numel()
        st['applied'] = st['applied'] + keep.sum(dtype=torch.int64)
        lt_new = _lt_from_S(S, w, nk, cfg.n_leaves, dtype, u=up)
    if update_slices:
        with span('tnco.walks.reslice'):
            if host_read((slices != 0).any(), bool):
                slices, lt_new = _reslice(S, slices, lt_new, dr['jitter'],
                                          max_width, log2d_w32, skip_w, cfg,
                                          uniform_log2, dtype, up, sp)
    with span('tnco.walks.snapshot'):
        st['slices'] = slices
        st['lt'] = lt_new
        _snapshot(st, lt_new, slices)


def _check_options(cfg, claim, on_block, accept_rule):
    """The ``ValueError``s of the walks engines' options."""
    if claim not in _CLAIMS:
        raise ValueError(f"claim must be one of {_CLAIMS}, got {claim!r}.")
    if on_block not in smw._ON_BLOCK:
        raise ValueError(f"on_block must be one of {smw._ON_BLOCK}, "
                         f"got {on_block!r}.")
    if accept_rule not in ('round', 'chained'):
        raise ValueError("accept_rule must be 'round' or 'chained', "
                         f"got {accept_rule!r}.")
    if cfg.prob_kind not in _PROB_KINDS:
        raise ValueError(f"prob_kind must be one of {_PROB_KINDS} for the "
                         f"walks engines, got {cfg.prob_kind!r}.")


def _walk_draws(draws, generator, t, nl, b, p, n_bits, dtype):
    """Iteration ``t``'s ``[B, P]`` draws: row ``t`` of ``draws``, or
    :func:`draw_walks` from ``generator``."""
    if draws is None:
        return draw_walks(generator, nl, b, p, n_bits, dtype)
    return {k: v[t] for k, v in draws.items()}


def _device_batch(batch, device, generator, draws):
    """The batch's device, after the device rule (:func:`resolve_device`)
    and the draws' source are checked."""
    dev = resolve_device(device)
    if batch.c0.device.type != dev.type:
        raise ValueError(f"batch is on {batch.c0.device}, device={dev}.")
    if draws is None and generator is None:
        raise ValueError("Pass draws= or generator=.")
    return batch.c0.device


def run_walks(batch: SABatch, betas, log2d_w32, cfg: SweepConfig, pos,
              sparse_wb=None, log2_n_projs=None, *, claim='sequential',
              on_block='advance', accept_rule='round', uniform_log2=None,
              draws=None, generator=None, device=None):
    """Infinite-memory chained multi-walk rounds, one per beta
    (``sa_walks.py:534-577``).

    Args:
        batch: :class:`~tnco_tpu_torch.kernels.sa_batched.SABatch` on
            ``device``.
        betas: ``[T]`` inverse temperatures, or ``[T, B]`` one per
            replica.
        log2d_w32: ``[W, 32]`` padded log2 dims in the state's float type
            (float32, or float64 under the float64 mode).
        cfg: :class:`SweepConfig` (``prob_kind`` 'mh', 'mh_local',
            'greedy' or 'base').
        pos: ``int32 [P, B]`` walk positions (-1 = start a fresh walk).
        sparse_wb, log2_n_projs: the sparse cost model's cap, or None.
        claim: 'sequential' or 'pairwise'.
        on_block: 'advance', 'restart' or 'dedup'.
        accept_rule: 'round' or 'chained'.
        uniform_log2: the common log2 dim (popcount widths), or None.
        draws: optional per-iteration stacks ``leaf``, ``rand_bit``,
            ``u`` ``[T, B, P]`` (the tests inject the JAX draws).
        generator: ``torch.Generator`` on the device, used when ``draws``
            is None.
        device: ``None`` means ``'cuda'`` (see :func:`resolve_device`).

    Returns ``(batch, {'moves', 'applied', 'pos'})``.  The batch's
    tensors are new; the packed working state is updated in place.
    """
    dev = _device_batch(batch, device, generator, draws)
    w = cfg.n_lanes
    nl = cfg.n_leaves
    dtype = log2d_w32.dtype
    nk = _nk(dtype)
    _check_options(cfg, claim, on_block, accept_rule)
    sp = sparse_args(sparse_wb, log2_n_projs)
    sp = {'sparse_w': sp['sparse_wb'], 'log2_n_projs': sp['log2_n_projs']}
    n, b = batch.c0.shape
    betas = smw.as_betas(betas, dev, b, dtype)
    opts = dict(claim=claim, on_block=on_block, accept_rule=accept_rule)

    S = _pack_w(batch.c0, batch.c1, batch.par, batch.inds, batch.lcc)
    S_min = _pack_w(batch.min_c0, batch.min_c1, batch.min_par,
                    batch.min_inds, batch.lcc)
    st = dict(S=S, lt=_lt_from_S(S, w, nk, nl, dtype), S_min=S_min,
              min_lt=batch.min_log2_total.clone(), pos=pos.T.contiguous(),
              moves=0, applied=torch.zeros((), dtype=torch.int64,
                                           device=dev))
    p = st['pos'].shape[1]
    for t in range(len(betas)):
        dr = _walk_draws(draws, generator, t, nl, b, p, 0, dtype)
        _iter_walks(st, betas[t], log2d_w32, cfg, uniform_log2, dr, sp, opts)

    S, lt = st['S'], st['lt']
    _snapshot(st, lt)
    c0, c1, par, inds, lcc = _unpack_w(S, w, dtype, n)
    mc0, mc1, mpar, minds, _ml = _unpack_w(st['S_min'], w, dtype, n)
    hyper = compute_hyper_b(c0, c1, inds)
    out = SABatch(c0, c1, par, inds, hyper, lcc, lt, st['min_lt'], mc0, mc1,
                  mpar, minds, batch.keys.clone())
    return out, {'moves': st['moves'], 'applied': st['applied'],
                 'pos': st['pos'].T.contiguous()}


def _union_planes(slicer, uniform_log2, w, sparse=False) -> int:
    """The slicer resolution of ``sa_walks.py:745-760``: the plane slicer
    (``W`` union planes) on uniform power-of-two dims without sparse
    indices unless ``slicer='ref'``; ``'plane'`` elsewhere raises."""
    if slicer not in (None, 'plane', 'ref'):
        raise ValueError(f"slicer must be None, 'plane' or 'ref', "
                         f"got {slicer!r}.")
    fast = (uniform_log2 is not None and not sparse and
            float(uniform_log2).is_integer())
    if slicer == 'plane' and not fast:
        raise ValueError("slicer='plane' needs uniform power-of-two dims "
                         "and no sparse indices.")
    return w if fast and slicer != 'ref' else 0


def run_walks_fw(batch: SABatchFW, betas, update_slices_mask, max_width,
                 log2d_w32, skip_wb, cfg: SweepConfig, pos, sparse_wb=None,
                 log2_n_projs=None, *, claim='sequential',
                 on_block='advance', accept_rule='round', uniform_log2=None,
                 slicer=None, draws=None, generator=None, device=None):
    """Finite-width chained multi-walk rounds, one per beta.

    Args:
        batch: :class:`SABatchFW` on ``device``.
        betas: ``[T]`` inverse temperatures, or ``[T, B]`` one per
            replica.
        update_slices_mask: ``[T]`` host booleans, reslice after step t.
        max_width: the width cap.
        log2d_w32: ``[W, 32]`` padded log2 dims in the state's float type
            (float32, or float64 under the float64 mode).
        skip_wb: ``int32 [W]`` (or ``[W, 1]``) lanes never sliced.
        cfg: a config with ``n_leaves``, ``n_lanes``, ``prob_kind`` and
            ``disable_shared_inds``.
        pos: ``int32 [P, B]`` walk positions (-1 = start a fresh walk).
        sparse_wb, log2_n_projs: the sparse cost model's cap
            (``int32 [W]`` or ``[W, 1]`` sparse bits; every cost's and
            width's sparse part at most ``log2_n_projs``), or None.
        claim, on_block, accept_rule: as in :func:`run_walks`.
        slicer: None (the plane slicer on uniform power-of-two dims
            without sparse indices, the reference-shaped one elsewhere),
            ``'plane'`` (required; other dims and sparse indices raise)
            or ``'ref'`` (forced).
        draws: optional pre-drawn streams, a dict of per-iteration stacks
            ``leaf [T, B, P]``, ``rand_bit [T, B, P]``, ``u [T, B, P]``,
            ``jitter [T, n_bits, B]`` (the tests inject the JAX draws).
        generator: ``torch.Generator`` on the device, used when ``draws``
            is None.
        device: ``None`` means ``'cuda'`` (see :func:`resolve_device`).

    Returns ``(batch, {'moves', 'applied', 'pos'})``.  The batch's
    tensors are new; the packed working state is updated in place.
    """
    dev = _device_batch(batch, device, generator, draws)
    w = cfg.n_lanes
    nl = cfg.n_leaves
    dtype = log2d_w32.dtype
    nk = _nk(dtype)
    _check_options(cfg, claim, on_block, accept_rule)
    sp = sparse_args(sparse_wb, log2_n_projs)
    sp = {'sparse_w': sp['sparse_wb'], 'log2_n_projs': sp['log2_n_projs']}
    up = _union_planes(slicer, uniform_log2, w, sp['sparse_w'] is not None)
    n, b = batch.c0.shape
    betas = smw.as_betas(betas, dev, b, dtype)
    mask = np.asarray(update_slices_mask, dtype=bool)
    max_width = torch.as_tensor(max_width, dtype=dtype, device=dev)
    skip_w = skip_wb.reshape(-1)
    opts = dict(claim=claim, on_block=on_block, accept_rule=accept_rule)

    with span('tnco.walks.pack'):
        S = _pack_w(batch.c0, batch.c1, batch.par, batch.inds, batch.lcc,
                    width=batch.width)
        S_min = _pack_w(batch.min_c0, batch.min_c1, batch.min_par,
                        batch.min_inds, batch.lcc, width=batch.width)
        if up:
            # Union planes U = inds[c0] | inds[c1], between the index
            # planes and c0 so the merged {B, A} apply scatter covers them
            # in one range.
            c0_pad = S[w].contiguous()
            c1_pad = S[w + 1].contiguous()
            U = (gather_gbn(S, c0_pad, planes=(0, w)) |
                 gather_gbn(S, c1_pad, planes=(0, w)))
            S = torch.cat([S[:w], U, S[w:]], dim=0).contiguous()
            # S_min's union planes are never read; they keep the snap
            # shapes equal.
            S_min = torch.cat([S_min[:w], U, S_min[w:]], dim=0).contiguous()

        st = dict(S=S, lt=_lt_from_S(S, w, nk, nl, dtype, u=up),
                  slices=batch.slices.clone(), S_min=S_min,
                  min_slices=batch.min_slices.clone(),
                  min_lt=batch.min_log2_total.clone(),
                  pos=pos.T.contiguous(), moves=0,
                  applied=torch.zeros((), dtype=torch.int64, device=dev))
    p = st['pos'].shape[1]
    for t in range(len(betas)):
        with span('tnco.walks.draws'):
            dr = _walk_draws(draws, generator, t, nl, b, p, w * 32, dtype)
        _iter_walks_fw(st, betas[t], bool(mask[t]), max_width, log2d_w32,
                       skip_w, cfg, uniform_log2, dr, up, sp, opts)

    with span('tnco.walks.unpack'):
        S, lt = st['S'], st['lt']
        _snapshot(st, lt, st['slices'])
        c0, c1, par, inds, lcc, width = _unpack_w(S, w, dtype, n, fw=True,
                                                  u=up)
        mc0, mc1, mpar, minds, _ml, _mw = _unpack_w(st['S_min'], w, dtype,
                                                    n, fw=True, u=up)
        hyper = compute_hyper_b(c0, c1, inds)
        out = SABatchFW(c0, c1, par, inds, hyper, lcc, width, st['slices'],
                        lt, st['min_lt'], mc0, mc1, mpar, minds,
                        st['min_slices'], batch.keys.clone())
    return out, {'moves': st['moves'], 'applied': st['applied'],
                 'pos': st['pos'].T.contiguous()}

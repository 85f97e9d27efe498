"""Multi-walk SA engines, infinite memory and finite width (the port of
``tnco_tpu/kernels/sa_multiwalk.py``: ``run_multiwalk`` and its helpers
:55-499, ``run_multiwalk_fw`` :502-649), plus the walk draws and the
conflict filter that the walks engine shares.

Each iteration, ``P`` walks per replica propose the reference uncle swap
at their node (include/tnco/optimize/infinite_memory/optimizer.hpp:
117-192), are Metropolis-accepted against the same pre-round total, a
pairwise-disjoint set is kept (lower walk index wins, only kept walks
block), the kept moves are applied, and every walk climbs to its parent.
The JAX engines' options are ported: ``on_block`` 'restart' and 'dedup'
(walks whose accepted move was discarded, or that stand on a lower
walk's node, restart), ``accept_rule='chained'`` (each walk is tested
against the running total of the kept walks before it), ``prob_kind``
'mh', 'greedy' or 'base', ``walk_chunk`` (the walks evaluate in groups;
the same results), float32 or float64 state.  The walks engine shares
the schedules and the claim scans.

The JAX engine reads and writes rows through ``[P, N, B]`` one-hot masks
(the TPU's cheap direction); this port reads rows with index gathers and
writes the kept rows with index scatters on the ``[N, B]`` / ``[N, W, B]``
tensors.  Kept rows are disjoint, so the writes equal the JAX engine's
additive updates; float rows are written in its form ``old + (new -
old)``.  Integer state is bitwise equal on the same state and draws and
totals agree within the float bound of ``exp2``/``log2`` (tests inject
the JAX draws through ``draws=``).

The finite-width iteration adds the width cap against the replica's
slice lanes (``fits``), slice-aware costs, the pre-slicing width of B
and, where the mask says so, the greedy reslice-if-better.

These are also the plain versions of the walker kernels K5-IM and K5-FW
(:mod:`tnco_tpu_torch.kernels.walker`), whose results equal them.  The
scatters route the rows of walks that are not kept to one dump row past
the last node, so an iteration has no data-dependent shapes and never
waits on the host (the reslice does: its slicer loops on the host).
"""

import numpy as np
import torch

# The sequential claim (one kernel launch on the card) and the conflict
# matrix of the 'pairwise' and 'chained' claims.
from tnco_tpu_torch.kernels.claim import claim_disjoint as _claim_disjoint
from tnco_tpu_torch.kernels.claim import conflicts as _conflicts
from tnco_tpu_torch.kernels.sa_batched import (SABatch, _log2_total_b,
                                               _width_b, compute_hyper_b,
                                               sparse_args)
from tnco_tpu_torch.kernels.sa_finite import _WIDTH_EPS
from tnco_tpu_torch.kernels.sa_finite_batched import (SABatchFW,
                                                      _greedy_slices_b,
                                                      _lcc_fw_b)
from tnco_tpu_torch.ops import costs as costs_ops
from tnco_tpu_torch.ops import rng

__all__ = ['run_multiwalk', 'run_multiwalk_fw', 'draw_walks', 'draw_chunk',
           'draw_chunk_fw', 'NULL']

NULL = -1

_ON_BLOCK = ('advance', 'restart', 'dedup')
_PROB_KINDS = ('mh', 'greedy', 'base')


def _chains_lt(cfg) -> bool:
    """Whether the acceptance rule depends on the total — i.e. whether
    ``accept_rule='chained'`` differs from 'round' at all (for the
    others the chained scan would change nothing, so the engines take
    the round path, as the JAX engines do)."""
    return cfg.prob_kind in ('mh', 'greedy')


def check_options(cfg, on_block='advance', accept_rule='round') -> None:
    """The ``ValueError``s of the multi-walk engines' options."""
    if on_block not in _ON_BLOCK:
        raise ValueError(f"on_block must be one of {_ON_BLOCK}, "
                         f"got {on_block!r}.")
    if accept_rule not in ('round', 'chained'):
        raise ValueError("accept_rule must be 'round' or 'chained', "
                         f"got {accept_rule!r}.")
    if cfg.prob_kind not in _PROB_KINDS:
        raise ValueError(f"prob_kind must be one of {_PROB_KINDS} for the "
                         f"multi-walk engines, got {cfg.prob_kind!r}.")


def walk_groups(n_walks: int, walk_chunk: int) -> list:
    """The walk slices that evaluate in turn (``_eval_chunked``,
    ``sa_multiwalk.py:129-150``): one group unless ``walk_chunk`` is in
    ``(0, P)``, which must divide ``P``.  Proposals are elementwise over
    the walks, so every grouping gives the same values."""
    if walk_chunk < 0:
        raise ValueError(f"walk_chunk ({walk_chunk}) must be >= 0.")
    if not walk_chunk or walk_chunk >= n_walks:
        return [slice(0, n_walks)]
    if n_walks % walk_chunk:
        raise ValueError(
            f"walk_chunk ({walk_chunk}) must divide n_walks ({n_walks}).")
    return [slice(g, g + walk_chunk)
            for g in range(0, n_walks, walk_chunk)]


def draw_walks(generator: torch.Generator, n_leaves: int, b: int, p: int,
               n_bits: int = 0, dtype=torch.float32):
    """One iteration's draws of the walks engines, on the generator's
    device.

    The counterpart of ``sa_multiwalk._draws(keys, n, p, dtype, 5)`` plus
    the reslice jitter: ``leaf [B, P]`` in ``[0, n_leaves)``, ``rand_bit
    [B, P]`` (bool), ``u [B, P]`` in ``[0, 1)`` and, finite width
    (``n_bits > 0``), ``jitter [n_bits, B]`` in ``[0, 1)``.  torch's
    generator gives other numbers than JAX's threefry from the same
    seed; tests inject the JAX draws instead.
    """
    leaf = rng.randint(generator, 0, n_leaves, (b, p), 0)
    rand_bit = rng.randint(generator, 0, 2, (b, p), 0) != 0
    u = rng.rand(generator, (b, p), 0, dtype)
    dr = {'leaf': leaf, 'rand_bit': rand_bit, 'u': u}
    if n_bits:
        dr['jitter'] = rng.rand(generator, (n_bits, b), -1, dtype)
    return dr


def draw_chunk(generator: torch.Generator, n_leaves: int, k: int, p: int,
               b: int, dtype=torch.float32):
    """A K-iteration chunk of IM walk draws in the JAX layout: ``leaf``
    (int32), ``rand_bit`` (bool) and ``u`` (``dtype``), each ``[K, P,
    B]`` — the streams ``pallas_walker._run_walker`` draws before its
    launch (``:514-520``), from a ``torch.Generator`` instead."""
    leaf = rng.randint(generator, 0, n_leaves, (k, p, b), -1)
    rand_bit = rng.randint(generator, 0, 2, (k, p, b), -1) != 0
    u = rng.rand(generator, (k, p, b), -1, dtype)
    return {'leaf': leaf, 'rand_bit': rand_bit, 'u': u}


def draw_chunk_fw(generator: torch.Generator, n_leaves: int, k: int, p: int,
                  b: int, n_bits: int, n_reslices: int, dtype=torch.float32):
    """A K-iteration chunk of FW walk draws: :func:`draw_chunk`'s
    streams plus ``jitter [R, n_bits, B]`` in ``[0, 1)``, one slicer
    jitter per reslice point of the chunk (true mask entry), in order."""
    dr = draw_chunk(generator, n_leaves, k, p, b, dtype)
    dr['jitter'] = rng.rand(generator, (n_reslices, n_bits, b), -1, dtype)
    return dr


def _take(arr, ids, n):
    """``arr[ids[b, p], ..., b]`` for ``arr [N', ..., B]`` and ids
    ``[B, P]``; ids outside ``[0, n)`` read zeros (the JAX engine's masked
    reductions sum no row for them).  Returns ``[..., B, P]``."""
    ok = (ids >= 0) & (ids < n)
    safe = torch.where(ok, ids, 0).long()
    if arr.dim() == 2:                                     # [N, B]
        got = torch.gather(arr.T, 1, safe)
        return torch.where(ok, got, torch.zeros((), dtype=arr.dtype,
                                                device=arr.device))
    w = arr.shape[1]                                       # [N, W, B]
    got = torch.gather(arr.permute(1, 2, 0), 2,
                       safe[None].expand(w, -1, -1))
    return torch.where(ok[None], got, torch.zeros((), dtype=arr.dtype,
                                                  device=arr.device))


def _propose(st, pos, leaf, rand_bit, cfg, n):
    """Proposal geometry of all walks (``[B, P]`` ids, ``[W, B, P]``
    lane sets): restart finished walks at a fresh leaf's parent, gather
    the {A, B, C, D, E} neighbourhood, pick D/E with the shared-index
    rule and build ``new_inds_b`` with on-the-fly hyper rows
    (``sa_multiwalk.py:73-123``)."""
    c0, c1, par, inds, lcc = st['c0'], st['c1'], st['par'], st['inds'], \
        st['lcc']
    par_pos = _take(par, pos.clamp(min=0), n)
    at_boundary = (pos == NULL) | (par_pos == NULL)
    b = torch.where(at_boundary, _take(par, leaf, n), pos)
    a = torch.where(b == NULL, NULL, _take(par, b, n))  # trivial-tree guard
    c0b, c1b = _take(c0, b, n), _take(c1, b, n)
    c0a, c1a = _take(c0, a, n), _take(c1, a, n)
    c = torch.where(c0a == b, c1a, c0a)

    inds_c = _take(inds, c, n)
    inds0 = _take(inds, c0b, n)
    inds1 = _take(inds, c1b, n)
    inds_a = _take(inds, a, n)
    inds_b = _take(inds, b, n)
    i0 = ((inds0 & inds_c) != 0).any(dim=0)
    i1 = ((inds1 & inds_c) != 0).any(dim=0)
    take0 = rand_bit if cfg.disable_shared_inds else \
        torch.where(i0 & i1, rand_bit, i0)
    t0 = take0[None]
    inds_d = torch.where(t0, inds0, inds1)
    inds_e = torch.where(t0, inds1, inds0)
    new_inds_b = ((inds_d ^ inds_c) | (inds_a & inds_b & inds_c) |
                  (inds_b & inds0 & inds1))
    return dict(a=a, b=b, c=c, d=torch.where(take0, c0b, c1b),
                e=torch.where(take0, c1b, c0b), c0a=c0a, c1a=c1a, c0b=c0b,
                c1b=c1b, inds_d=inds_d, inds_e=inds_e, inds_c=inds_c,
                new_inds_b=new_inds_b, l_a=_take(lcc, a, n),
                l_b=_take(lcc, b, n))


def _accept(cfg, u, beta, l_new, lt, ev):
    """The acceptance rule of every walk against the pre-round total;
    root-adjacent walks (no uncle) only advance.  ``beta`` is 0-dim or
    ``[B]`` (one temperature per replica)."""
    if cfg.prob_kind == 'mh':
        if beta.ndim:
            beta = beta[:, None]
        acc = torch.log2(u) <= -beta * (l_new - lt[:, None])
    elif cfg.prob_kind == 'greedy':
        acc = l_new <= lt[:, None]
    else:
        acc = torch.ones_like(l_new, dtype=torch.bool)
    return acc & (ev['b'] != NULL) & (ev['a'] != NULL)


def _chained_accept_step(cfg, lt_run, beta, u_i, l_a, l_b, ln_a, ln_b):
    """One walk's decision against the RUNNING total (``sa_multiwalk.py:
    207-219``): the op tree both engines' chained scans share.  ``beta``
    is 0-dim or ``[B]``."""
    l_new = costs_ops.new_total_log2(lt_run, l_a, l_b, ln_a, ln_b)
    if cfg.prob_kind == 'mh':
        acc = torch.log2(u_i) <= -beta * (l_new - lt_run)
    else:                           # 'greedy' (the others never chain)
        acc = l_new <= lt_run
    return acc, l_new


def _claim_chained(cfg, u, beta, lt, valid, ev):
    """Chained acceptance and claims in one priority scan
    (``sa_multiwalk.py:234-280``): walk ``i`` is tested against the
    running total of the lower-index walks that were KEPT, so a round of
    disjoint kept moves is a sequential Metropolis chain.  A Python loop
    over the ``P`` walks, each step a few dozen small launches (ROADMAP
    item 17).  ``u``, ``valid`` and the ``ev`` costs are ``[B, P]``;
    returns ``(accept, keep)`` ``[B, P]``, ``accept`` holding each walk's
    decision at its own chain point."""
    confl = _conflicts(ev)
    keep = torch.zeros_like(valid)
    accept = torch.zeros_like(valid)
    lt_run = lt
    for i in range(valid.shape[1]):
        blocked = (keep & confl[:, i, :]).any(dim=1)
        acc, l_new = _chained_accept_step(
            cfg, lt_run, beta, u[:, i], ev['l_a'][:, i], ev['l_b'][:, i],
            ev['ln_a'][:, i], ev['ln_b'][:, i])
        acc = acc & valid[:, i]
        kp = acc & ~blocked
        lt_run = torch.where(kp, l_new, lt_run)
        keep[:, i] = kp
        accept[:, i] = acc
    return accept, keep


def _advance_walks(pos_a, accept, keep, on_block):
    """Next walk positions after the claims, ``[B, P]`` (walk axis last;
    ``sa_multiwalk.py:170-204``), shared by both walk engines.

    ``'advance'``: every walk climbs to A.  ``'restart'``: a walk whose
    ACCEPTED proposal the claim discarded restarts at a fresh leaf (-1)
    instead, which breaks convoys of colliding walks; rejected walks
    still climb.  ``'dedup'``: 'restart', and a walk standing on the
    node of a live lower-index walk restarts too."""
    if on_block == 'advance':
        return pos_a
    pos = torch.where(accept & ~keep, NULL, pos_a)
    if on_block == 'dedup':
        p = pos.shape[1]
        idx = torch.arange(p, device=pos.device)
        lower = idx[None, :] < idx[:, None]                # [q, p]: p < q
        same = pos[:, :, None] == pos[:, None, :]          # [B, q, p]
        dup = (same & lower[None]).any(dim=2) & (pos != NULL)
        pos = torch.where(dup, NULL, pos)
    return pos


def _apply_kept(st, keep, ev, n):
    """Writes the 4 touched rows of every kept walk into the padded
    state ``st`` (one dump row at index ``n`` takes the rest); with a
    ``width`` entry (finite width), B's pre-slicing width follows the
    rewrite as ``w_b + (new_width_b - w_b)``."""
    b_, p = keep.shape
    ri = torch.arange(b_, device=keep.device)[:, None].expand(b_, p)

    def put(arr, ids, vals):
        rows = torch.where(keep, ids, n)
        arr.index_put_((rows.reshape(-1), ri.reshape(-1)),
                       vals.reshape(-1))

    a, b, c, e = ev['a'], ev['b'], ev['c'], ev['e']
    if 'width' in st:
        w_b = _take(st['width'], b, n)
        put(st['width'], b, w_b + (ev['new_width_b'] - w_b))
    put(st['c0'], b, torch.where(ev['c0b'] == e, c, ev['c0b']))
    put(st['c1'], b, torch.where(ev['c1b'] == e, c, ev['c1b']))
    put(st['c0'], a, torch.where(ev['c0a'] == c, e, ev['c0a']))
    put(st['c1'], a, torch.where(ev['c1a'] == c, e, ev['c1a']))
    put(st['par'], b, a)
    put(st['par'], c, b)
    put(st['par'], e, a)
    put(st['lcc'], b, ev['l_b'] + (ev['ln_b'] - ev['l_b']))
    put(st['lcc'], a, ev['l_a'] + (ev['ln_a'] - ev['l_a']))
    rows = torch.where(keep, b, n).reshape(-1)
    w = st['inds'].shape[1]
    st['inds'][rows, :, ri.reshape(-1)] = \
        ev['new_inds_b'].reshape(w, -1).T


def _evaluate(st, dr, groups, body):
    """``body(pos, leaf, rand_bit)`` over the walk groups (``[B, Pg]``
    slices of the draws), joined on the walk axis (last)."""
    evs = [body(st['pos'][:, g], dr['leaf'][:, g], dr['rand_bit'][:, g])
           for g in groups]
    if len(evs) == 1:
        return evs[0]
    return {k: torch.cat([e[k] for e in evs], dim=-1) for k in evs[0]}


def _claims(cfg, dr, beta, lt, ev, accept_rule, fits=None):
    """Acceptance and claims of one iteration: the chained scan where
    ``accept_rule='chained'`` changes anything, else the round rule and
    the sequential claim.  Returns ``(accept, keep)``."""
    valid = (ev['b'] != NULL) & (ev['a'] != NULL)
    if fits is not None:
        valid = valid & fits
    if accept_rule == 'chained' and _chains_lt(cfg):
        return _claim_chained(cfg, dr['u'], beta, lt, valid, ev)
    l_new = costs_ops.new_total_log2(lt[:, None], ev['l_a'], ev['l_b'],
                                     ev['ln_a'], ev['ln_b'])
    accept = _accept(cfg, dr['u'], beta, l_new, lt, ev)
    if fits is not None:
        accept = accept & fits
    return accept, _claim_disjoint(accept, ev)


def _iter_multiwalk(st, beta, dr, log2d_w32, cfg, uniform_log2, n, sp,
                    on_block='advance', accept_rule='round', groups=None):
    """One iteration on the padded state dict ``st`` (updated in place).
    ``dr`` holds this iteration's ``[B, P]`` draws; ``sp``:
    :func:`~tnco_tpu_torch.kernels.sa_batched.sparse_args`; ``groups``:
    :func:`walk_groups` (None: one group)."""
    lt = _log2_total_b(st['lcc'][:n], cfg.n_leaves)

    def body(pos, leaf, rand_bit):
        ev = _propose(st, pos, leaf, rand_bit, cfg, n)
        ev['ln_b'] = _width_b(ev['inds_d'] | ev['inds_c'], log2d_w32,
                              uniform_log2=uniform_log2, **sp)
        ev['ln_a'] = _width_b(ev['new_inds_b'] | ev['inds_e'], log2d_w32,
                              uniform_log2=uniform_log2, **sp)
        return ev

    ev = _evaluate(st, dr, groups or [slice(None)], body)
    accept, keep = _claims(cfg, dr, beta, lt, ev, accept_rule)
    _apply_kept(st, keep, ev, n)

    st['pos'] = _advance_walks(ev['a'], accept, keep, on_block)
    st['moves'] += keep.numel()
    st['applied'] = st['applied'] + keep.sum(dtype=torch.int64)
    _snapshot(st, n, cfg.n_leaves)


def _snapshot(st, n, n_leaves):
    """Min tracking: replicas whose exact total is strictly below their
    min take the current state (and slices, finite width) as their min."""
    lt_new = _log2_total_b(st['lcc'][:n], n_leaves)
    improved = lt_new < st['min_lt']
    st['min_lt'] = torch.where(improved, lt_new, st['min_lt'])
    for k in ('c0', 'c1', 'par', 'inds', 'slices'):
        if k not in st:
            continue
        cur = st[k] if k == 'slices' else st[k][:n]
        st['min_' + k] = torch.where(
            improved.reshape((1,) * (cur.dim() - 1) + (-1,)), cur,
            st['min_' + k])


def _iter_multiwalk_fw(st, beta, dr, max_width, log2d_w32, cfg,
                       uniform_log2, n, sp, on_block='advance',
                       accept_rule='round', groups=None):
    """One finite-width iteration on the padded state dict ``st``
    (updated in place), WITHOUT the reslice and the min snapshot, which
    the callers order (``sa_multiwalk.py:502-598``): proposals are
    costed against the slice lanes, and one whose sliced width exceeds
    the cap is not accepted.  Returns the kept mask ``[B, P]``."""
    lt = _log2_total_b(st['lcc'][:n], cfg.n_leaves)
    sl = st['slices'][:, :, None]           # [W, B, 1] over the walks

    def width(lanes):
        return _width_b(lanes, log2d_w32, uniform_log2=uniform_log2, **sp)

    def body(pos, leaf, rand_bit):
        ev = _propose(st, pos, leaf, rand_bit, cfg, n)
        ev['new_width_b'] = width(ev['new_inds_b'])
        ev['fits'] = width(ev['new_inds_b'] & ~sl) <= max_width + _WIDTH_EPS
        ev['ln_b'] = width((ev['inds_d'] | ev['inds_c']) | sl)
        ev['ln_a'] = width((ev['new_inds_b'] | ev['inds_e']) | sl)
        return ev

    ev = _evaluate(st, dr, groups or [slice(None)], body)
    accept, keep = _claims(cfg, dr, beta, lt, ev, accept_rule, ev['fits'])
    _apply_kept(st, keep, ev, n)

    st['pos'] = _advance_walks(ev['a'], accept, keep, on_block)
    st['moves'] += keep.numel()
    st['applied'] = st['applied'] + keep.sum(dtype=torch.int64)
    return keep


def reslice_if_better(c0, c1, inds, width, slices, lcc, jitter, max_width,
                      log2d_w32, skip_wb, n_leaves, uniform_log2=None,
                      sparse_wb=None, log2_n_projs=None):
    """The periodic greedy reslice: new slices from the pre-slicing
    widths, kept by the replicas whose total improves.  Returns
    ``(slices, lcc)``.  Callers skip it when no replica has a slice
    (the reference's ``has_slices``, global over the batch)."""
    new_slices = _greedy_slices_b(c0, inds, width, jitter, max_width,
                                  log2d_w32, skip_wb, sparse_wb,
                                  log2_n_projs, uniform_log2=uniform_log2)
    new_lcc = _lcc_fw_b(c0, c1, inds, new_slices, log2d_w32, sparse_wb,
                        log2_n_projs, uniform_log2=uniform_log2)
    better = _log2_total_b(new_lcc, n_leaves) < _log2_total_b(lcc, n_leaves)
    return (torch.where(better[None, :], new_slices, slices),
            torch.where(better[None, :], new_lcc, lcc))


def finish_batch(c0, c1, par, inds, lcc, min_lt, min_c0, min_c1, min_par,
                 min_inds, keys, n_leaves) -> SABatch:
    """Final min check and hyper refresh (``sa_multiwalk.py:487-498``):
    the batch a chunk returns, with ``hyper`` rebuilt through K1."""
    lt = _log2_total_b(lcc, n_leaves)
    improved = lt < min_lt
    min_lt = torch.where(improved, lt, min_lt)
    impn, impw = improved[None, :], improved[None, None, :]
    min_c0 = torch.where(impn, c0, min_c0)
    min_c1 = torch.where(impn, c1, min_c1)
    min_par = torch.where(impn, par, min_par)
    min_inds = torch.where(impw, inds, min_inds)
    hyper = compute_hyper_b(c0, c1, inds)
    return SABatch(c0, c1, par, inds, hyper, lcc, lt, min_lt, min_c0,
                   min_c1, min_par, min_inds, keys)


def finish_batch_fw(c0, c1, par, inds, lcc, width, slices, min_lt, min_c0,
                    min_c1, min_par, min_inds, min_slices, keys,
                    n_leaves) -> SABatchFW:
    """:func:`finish_batch` for finite width (``sa_multiwalk.py:
    636-649``): the final min check also takes the slices."""
    improved = _log2_total_b(lcc, n_leaves) < min_lt
    min_slices = torch.where(improved[None, :], slices, min_slices)
    im = finish_batch(c0, c1, par, inds, lcc, min_lt, min_c0, min_c1,
                      min_par, min_inds, keys, n_leaves)
    return SABatchFW(im.c0, im.c1, im.par, im.inds, im.hyper, im.lcc, width,
                     slices, im.log2_total, im.min_log2_total, im.min_c0,
                     im.min_c1, im.min_par, im.min_inds, min_slices, keys)


def padded_state(c0, c1, par, inds, lcc, width=None) -> dict:
    """The engines' working state: the node-axis tensors with one inert
    dump row appended (children and parent NULL, no index bits, lcc
    -inf, width 0)."""
    def pad1(x, fill):
        return torch.cat([x, x.new_full((1,) + x.shape[1:], fill)])

    st = dict(c0=pad1(c0, NULL), c1=pad1(c1, NULL), par=pad1(par, NULL),
              inds=pad1(inds, 0), lcc=pad1(lcc, -torch.inf))
    if width is not None:
        st['width'] = pad1(width, 0.0)
    return st


def as_betas(betas, device, b=None, dtype=torch.float32) -> torch.Tensor:
    """``[K]`` or per-replica ``[K, B]`` betas of the state's float type
    on ``device`` (a host sequence is copied; ``b`` checks ``B``)."""
    betas = torch.as_tensor(
        betas if isinstance(betas, torch.Tensor) else
        np.asarray(betas, dtype=np.float64),
        dtype=dtype, device=device)
    if betas.dim() not in (1, 2) or (
            betas.dim() == 2 and b is not None and betas.shape[1] != b):
        raise ValueError(f"betas must be [K] or [K, {b}], got "
                         f"{tuple(betas.shape)}.")
    return betas


def run_multiwalk(batch: SABatch, betas, log2d_w32, cfg, n_walks: int, pos,
                  sparse_wb=None, log2_n_projs=None, uniform_log2=None,
                  on_block='advance', accept_rule='round', *, walk_chunk=0,
                  draws=None, generator=None):
    """Runs one multi-walk iteration per beta (``P`` proposals per
    replica per iteration) on the batch's device.

    Args:
        batch: :class:`SABatch`.
        betas: ``[K]`` inverse temperatures, or ``[K, B]`` per replica.
        log2d_w32: ``[W, 32]`` padded log2 dims, in the state's float
            type (float32, or float64 under the float64 mode).
        cfg: :class:`~tnco_tpu_torch.kernels.sa_infinite.SweepConfig`.
        n_walks: walks per replica ``P``.
        pos: ``int32 [P, B]`` walk positions (-1 = start a fresh walk).
        sparse_wb, log2_n_projs: the sparse cost model's cap (``int32
            [W]`` or ``[W, 1]`` sparse bits; every cost's sparse part at
            most ``log2_n_projs``), or None.
        on_block: 'advance', 'restart' or 'dedup' (:func:`_advance_walks`).
        accept_rule: 'round' (every walk against the pre-round total) or
            'chained' (:func:`_claim_chained`).
        walk_chunk: evaluate the walks in groups of this size (0: one
            group; in ``(0, P)`` it must divide ``P``); the results are
            the same for every value.
        draws: optional pre-drawn streams ``leaf``, ``rand_bit``, ``u``,
            each ``[K, P, B]`` (the JAX layout; tests inject the JAX
            draws).
        generator: ``torch.Generator`` on the batch's device, used when
            ``draws`` is None (:func:`draw_chunk`).

    Returns ``(batch, {'moves', 'applied', 'pos'})`` with ``pos`` as
    ``int32 [P, B]``.  The input batch is not modified.
    """
    dtype = log2d_w32.dtype
    check_options(cfg, on_block, accept_rule)
    groups = walk_groups(n_walks, walk_chunk)
    sp = sparse_args(sparse_wb, log2_n_projs)
    dev = batch.c0.device
    n, b = batch.c0.shape
    if tuple(pos.shape) != (n_walks, b):
        raise ValueError(f"pos must be [{n_walks}, {b}], got "
                         f"{tuple(pos.shape)}.")
    betas = as_betas(betas, dev, b, dtype)
    k = betas.shape[0]
    if draws is None:
        if generator is None:
            raise ValueError("Pass draws= or generator=.")
        draws = draw_chunk(generator, cfg.n_leaves, k, n_walks, b, dtype)

    st = padded_state(batch.c0, batch.c1, batch.par, batch.inds, batch.lcc)
    st.update(min_c0=batch.min_c0, min_c1=batch.min_c1,
              min_par=batch.min_par, min_inds=batch.min_inds,
              min_lt=batch.min_log2_total, pos=pos.T, moves=0,
              applied=torch.zeros((), dtype=torch.int64, device=dev))
    for t in range(k):
        dr = {name: draws[name][t].T for name in ('leaf', 'rand_bit', 'u')}
        dr['rand_bit'] = dr['rand_bit'] != 0
        _iter_multiwalk(st, betas[t], dr, log2d_w32, cfg, uniform_log2, n,
                        sp, on_block, accept_rule, groups)

    out = finish_batch(st['c0'][:n], st['c1'][:n], st['par'][:n],
                       st['inds'][:n], st['lcc'][:n], st['min_lt'],
                       st['min_c0'], st['min_c1'], st['min_par'],
                       st['min_inds'], batch.keys.clone(), cfg.n_leaves)
    return out, {'moves': st['moves'], 'applied': st['applied'],
                 'pos': st['pos'].T.contiguous()}


def fw_draws(draws, generator, mask, cfg, n_walks, b, dtype, device):
    """The FW chunk's draws, checked (or drawn from ``generator``):
    ``leaf``, ``rand_bit``, ``u`` ``[K, P, B]`` and ``jitter [R, n_bits,
    B]`` with ``R`` the number of true entries of ``mask``."""
    k, r = len(mask), int(np.count_nonzero(mask))
    n_bits = cfg.n_lanes * 32
    if draws is None:
        if generator is None:
            raise ValueError("Pass draws= or generator=.")
        return draw_chunk_fw(generator, cfg.n_leaves, k, n_walks, b, n_bits,
                             r, dtype)
    want = {'leaf': (k, n_walks, b), 'rand_bit': (k, n_walks, b),
            'u': (k, n_walks, b), 'jitter': (r, n_bits, b)}
    for name, shape in want.items():
        x = draws[name]
        if tuple(x.shape) != shape or x.device != device:
            raise ValueError(f"draws[{name!r}] must be {list(shape)} on "
                             f"{device}, got {tuple(x.shape)} on {x.device}.")
    return draws


def run_multiwalk_fw(batch: SABatchFW, betas, update_slices_mask, max_width,
                     log2d_w32, skip_wb, cfg, n_walks: int, pos,
                     sparse_wb=None, log2_n_projs=None, uniform_log2=None,
                     on_block='advance', accept_rule='round', *,
                     walk_chunk=0, draws=None, generator=None):
    """Finite-width multi-walk: one iteration per beta on the batch's
    device (``sa_multiwalk.py:502-649``).

    Args:
        batch: :class:`~tnco_tpu_torch.kernels.sa_finite_batched.SABatchFW`.
        betas: ``[K]`` inverse temperatures, or ``[K, B]`` per replica.
        update_slices_mask: ``[K]`` host booleans; iteration ``t`` ends
            with the greedy reslice-if-better where it is true (and some
            replica has a slice).
        max_width: the width cap.
        log2d_w32: ``[W, 32]`` padded log2 dims (the state's float type).
        skip_wb: ``int32 [W]`` (or ``[W, 1]``) lanes never sliced.
        cfg: a config with ``n_leaves``, ``n_lanes``, ``prob_kind`` and
            ``disable_shared_inds`` (``SweepConfigFW``).
        n_walks: walks per replica ``P``.
        pos: ``int32 [P, B]`` walk positions (-1 = start a fresh walk).
        sparse_wb, log2_n_projs: the sparse cost model's cap, or None
            (as in :func:`run_multiwalk`; the slicer then takes its
            reference path).
        uniform_log2: the common log2 dim, or None (popcount widths and
            the fast slicer where it is an integer).
        on_block, accept_rule, walk_chunk: as in :func:`run_multiwalk`.
        draws: optional ``leaf``, ``rand_bit``, ``u`` ``[K, P, B]`` and
            ``jitter [R, n_bits, B]``, one jitter per true mask entry in
            order (tests inject the JAX draws).
        generator: ``torch.Generator`` on the batch's device, used when
            ``draws`` is None (:func:`draw_chunk_fw`).

    Returns ``(batch, {'moves', 'applied', 'pos'})``.  The input batch
    is not modified.
    """
    dtype = log2d_w32.dtype
    check_options(cfg, on_block, accept_rule)
    groups = walk_groups(n_walks, walk_chunk)
    sp = sparse_args(sparse_wb, log2_n_projs)
    dev = batch.c0.device
    n, b = batch.c0.shape
    if tuple(pos.shape) != (n_walks, b):
        raise ValueError(f"pos must be [{n_walks}, {b}], got "
                         f"{tuple(pos.shape)}.")
    betas = as_betas(betas, dev, b, dtype)
    mask = np.asarray(update_slices_mask, dtype=bool)
    if mask.shape != (betas.shape[0],):
        raise ValueError("update_slices_mask must match betas, got "
                         f"{mask.shape} for {betas.shape[0]} betas.")
    draws = fw_draws(draws, generator, mask, cfg, n_walks, b, dtype, dev)
    max_width = torch.as_tensor(max_width, dtype=dtype, device=dev)

    st = padded_state(batch.c0, batch.c1, batch.par, batch.inds, batch.lcc,
                      batch.width)
    st.update(slices=batch.slices, min_c0=batch.min_c0, min_c1=batch.min_c1,
              min_par=batch.min_par, min_inds=batch.min_inds,
              min_slices=batch.min_slices, min_lt=batch.min_log2_total,
              pos=pos.T, moves=0,
              applied=torch.zeros((), dtype=torch.int64, device=dev))
    r = 0
    for t in range(len(mask)):
        dr = {name: draws[name][t].T for name in ('leaf', 'rand_bit', 'u')}
        dr['rand_bit'] = dr['rand_bit'] != 0
        _iter_multiwalk_fw(st, betas[t], dr, max_width, log2d_w32, cfg,
                           uniform_log2, n, sp, on_block, accept_rule,
                           groups)
        if mask[t]:
            if bool((st['slices'] != 0).any()):
                st['slices'], st['lcc'][:n] = reslice_if_better(
                    st['c0'][:n], st['c1'][:n], st['inds'][:n],
                    st['width'][:n], st['slices'], st['lcc'][:n],
                    draws['jitter'][r], max_width, log2d_w32, skip_wb,
                    cfg.n_leaves, uniform_log2, **sp)
            r += 1
        _snapshot(st, n, cfg.n_leaves)

    out = finish_batch_fw(
        st['c0'][:n], st['c1'][:n], st['par'][:n], st['inds'][:n],
        st['lcc'][:n], st['width'][:n], st['slices'], st['min_lt'],
        st['min_c0'], st['min_c1'], st['min_par'], st['min_inds'],
        st['min_slices'], batch.keys.clone(), cfg.n_leaves)
    return out, {'moves': st['moves'], 'applied': st['applied'],
                 'pos': st['pos'].T.contiguous()}

"""The synchronous full-tree 'sweep' engine and the plane codecs and
widths it shares with the other engines (the port of
``tnco_tpu/kernels/sa_fullsweep.py``: codecs and widths :88-205,
``_propose`` :229-326, ``_accept`` :329-363, ``_luby_keep`` :366-380,
``_apply`` :383-465, ``_iter_fullsweep`` and ``run_fullsweep``
:468-529, ``_iter_fullsweep_fw`` and ``run_fullsweep_fw`` :535-663).
The packing, the order-pinned totals (``_log2_total_bn`` :208-226) and
the min snapshot are the lockstep engines' (:mod:`~tnco_tpu_torch.
kernels.sa_batched`), on the same plane layout.

Every internal node ``B`` proposes its uncle swap at once each round
(the root's proposal is always rejected: it has no parent), so ``b`` is
the row index itself.  The per-node proposal is the reference's
(infinite_memory/optimizer.hpp:117-192; finite_width/greedy/
optimizer.hpp:188-225 with the width cap).  Proposals that conflict are
resolved by one round of random-priority independent-set selection
(Luby): an accepted node is kept iff its priority beats every accepted
proposal among its 12 neighbours (parent, sibling, both children,
grandparent, uncle, both nephews, the four grandchildren), so the kept
``{A, B, C, D, E}`` sets are pairwise disjoint and apply at once.  The
default ``prob_kind`` of the runners is 'mh_local': Metropolis on the
pair ratio ``(2^ln_a + 2^ln_b) / (2^l_a + 2^l_b)``; 'mh' is the
reference's totals rule through :func:`~tnco_tpu_torch.ops.costs.
delta_log2_local`.

The state is int32 ``[F, B, N]`` planes of bit patterns: index words,
child/parent ids, and float costs bitcast into ``nk`` planes (one for
float32, two for float64, low word first, as the JAX package's
``bitcast_convert_type`` gives them).  Ids and words already are int32,
so the JAX package's ``_u32``/``_i32`` bitcasts have no counterpart
here.  Every irregular read of a round is one call of the row gather K1
(:func:`~tnco_tpu_torch.kernels.gather.gather_gbn`): seven a round,
two to propose, one for the Luby neighbours, four to apply.  The
apply step has no scatter: each row pulls its own role (kept proposer
B, parent A of a kept B, sibling C that moves under B, child E that
moves under A).

Draws: ``draws=`` (``u [K, B, NI]`` in the state's dtype, ``bits [K, B,
NI]`` int32; tests inject the JAX package's threefry streams) or a
``torch.Generator``.  Integer and bit state equal the JAX engine's
bitwise on the same state and draws; totals agree within the float
bound of ``exp2``/``log2``.
"""

import numpy as np
import torch

from tnco_tpu_torch.kernels.gather import gather_gbn
from tnco_tpu_torch.ops import costs as costs_ops
from tnco_tpu_torch.ops.bitops import popcount32

__all__ = ['run_fullsweep', 'run_fullsweep_fw', 'draw_round',
           'uniform_log2_dim', 'PROB_KINDS']

NULL = -1
PROB_KINDS = ('mh', 'mh_local', 'greedy', 'base')
# Floor of the pair sums of 'mh_local' (the clamp of ops.costs).
_SCALED_FLOOR = 2.0**-60
# Priority layout: bit 31 clear, bits 30..15 random, bits 14..0 the node
# id, so two proposals of one replica never tie.  Ids above 32767 share
# bits with the random part, as in the JAX package (Sycamore m=20 has
# N=3241); the width stays as it is there.
_PRIO_ID_BITS = 15
_PRIO_RAND_MASK = (0xFFFFFFFF << _PRIO_ID_BITS) & 0x7FFFFFFF


def uniform_log2_dim(log2_dims) -> float | None:
    """The common log2 dim if every (unpadded) index dim is equal, else
    None.  Host-side: pass ``ContractionTree.log2_dims_array``."""
    a = np.asarray(log2_dims, dtype=np.float64)
    if a.size == 0:
        return 0.0
    if np.all(a == a.flat[0]):
        return float(a.flat[0])
    return None


def _split_f(x):
    """float tensor -> ``[nk, ...]`` int32 bit-pattern planes: float32
    one plane, float64 two (the low word first)."""
    if x.dtype == torch.float32:
        return x.view(torch.int32)[None]
    words = x.contiguous().reshape(tuple(x.shape) + (1,)).view(torch.int32)
    return words.movedim(-1, 0)


def _join_f(planes, dtype):
    """Inverse of :func:`_split_f` (planes ``[nk, ...]``), bitwise."""
    if planes.shape[0] == 1:
        return planes[0].view(dtype)
    # Through a flat copy: a size-1 axis may keep any stride, which a
    # wider dtype's view refuses.
    words = planes.movedim(0, -1).contiguous()
    return words.flatten().view(dtype).reshape(words.shape[:-1])


def _nk(dtype):
    return 2 if torch.empty((), dtype=dtype).element_size() == 8 else 1


def _width_bn(lanes_wbn, log2d_w32, uniform_log2, dtype, *, sparse_w=None,
              log2_n_projs=None):
    """Width of ``int32 [W, ...]`` lane sets -> ``[...]``.

    Fast path (``uniform_log2`` given): integer popcount times the common
    log2 dim.  Otherwise the (w*32+s)-ordered pairwise-halving tree over
    the bit-plane expansion.  With ``sparse_w`` (``int32 [W]``, the
    sparse indices' bits): the dense part's width plus ``min(sparse
    part's width, log2_n_projs)``, each part by the rule above.
    """
    if sparse_w is not None:
        sp = sparse_w.reshape((-1,) + (1,) * (lanes_wbn.ndim - 1))
        dense = _width_bn(lanes_wbn & ~sp, log2d_w32, uniform_log2, dtype)
        sparse = _width_bn(lanes_wbn & sp, log2d_w32, uniform_log2, dtype)
        return dense + torch.clamp(sparse, max=float(log2_n_projs))
    if uniform_log2 is not None:
        pc = popcount32(lanes_wbn).sum(dim=0, dtype=torch.int32)
        return pc.to(dtype) * torch.tensor(uniform_log2, dtype=dtype,
                                           device=lanes_wbn.device)
    w = lanes_wbn.shape[0]
    rest = (1,) * (lanes_wbn.ndim - 1)
    sh = torch.arange(32, dtype=torch.int32,
                      device=lanes_wbn.device).reshape((1, 32) + rest)
    bits = ((lanes_wbn[:, None] >> sh) & 1).to(dtype)
    ld = log2d_w32.reshape((w, 32) + rest)
    terms = (bits * ld).reshape((w * 32,) + tuple(lanes_wbn.shape[1:]))
    n = w * 32
    p = 1 << (n - 1).bit_length() if n > 1 else 1
    if p != n:
        terms = torch.cat(
            [terms, terms.new_zeros((p - n,) + tuple(terms.shape[1:]))],
            dim=0)
    while terms.shape[0] > 1:
        h = terms.shape[0] // 2
        terms = terms[:h] + terms[h:]
    return terms[0]


def _widths(lane_sets, log2d_w32, uniform_log2, dtype, sp):
    """Widths of several ``[W, B, NI]`` lane sets in one pass (elementwise
    over the stacked sets, so each equals its own call)."""
    return _width_bn(torch.stack(lane_sets, 1), log2d_w32, uniform_log2,
                     dtype, sparse_w=sp['sparse_wb'],
                     log2_n_projs=sp['log2_n_projs']).unbind(0)


def _propose(S, bits, cfg, log2d_w32, uniform_log2, dtype, sp,
             slices_wb=None):
    """Every internal node's proposal: the ``ev`` dict of ids and costs
    ``[B, NI]`` and lane sets ``[W, B, NI]``, and the ``[B, 12 * NI]``
    Luby neighbour ids.  Two K1 reads: the parent rows, then the rows of
    the sibling, both children and the grandparent in one call.  With
    ``slices_wb`` (finite width) the costs carry the slices, and ``ev``
    also holds the new pre-slicing width of B and its sliced width."""
    w, nl = cfg.n_lanes, cfg.n_leaves
    nk = _nk(dtype)
    b_dim, n = S.shape[1], S.shape[2]
    ni = n - nl
    # Bit 31 of the draw, read as the sign (a torch >> on int32 is
    # arithmetic).
    rand_bit = bits < 0

    b_ids = torch.arange(nl, n, dtype=torch.int32,
                         device=S.device).expand(b_dim, ni)
    inds_b = S[:w, :, nl:]
    c0b = S[w, :, nl:]
    c1b = S[w + 1, :, nl:]
    a = S[w + 2, :, nl:].contiguous()
    l_b = _join_f(S[w + 3:w + 3 + nk, :, nl:], dtype)

    # Pull 1: full rows at the parent (K1 reads NULL ids as 0).
    ra = gather_gbn(S, a, planes=(0, w + 3 + nk))
    inds_a = ra[:w]
    c0a, c1a = ra[w], ra[w + 1]
    gp = torch.where(a == NULL, NULL, ra[w + 2])
    l_a = _join_f(ra[w + 3:w + 3 + nk], dtype)
    c = torch.where(c0a == b_ids, c1a, c0a)

    # Pull 2: rows at the sibling, both children, the grandparent.
    ids2 = torch.cat([c, c0b, c1b, gp], dim=1)
    rc, r0, r1, rgp = gather_gbn(S, ids2, planes=(0, w + 2)).split(ni, 2)
    inds_c = rc[:w]
    inds0, inds1 = r0[:w], r1[:w]
    uncle = torch.where(rgp[w] == a, rgp[w + 1], rgp[w])
    uncle = torch.where(gp == NULL, NULL, uncle)

    i0 = ((inds0 & inds_c) != 0).any(dim=0)
    i1 = ((inds1 & inds_c) != 0).any(dim=0)
    take0 = (rand_bit if cfg.disable_shared_inds else
             torch.where(i0 & i1, rand_bit, i0))
    d = torch.where(take0, c0b, c1b)
    e = torch.where(take0, c1b, c0b)
    inds_d = torch.where(take0[None], inds0, inds1)
    inds_e = torch.where(take0[None], inds1, inds0)
    new_inds_b = ((inds_d ^ inds_c) | (inds_a & inds_b & inds_c) |
                  (inds_b & inds0 & inds1))

    sets = [inds_d | inds_c, new_inds_b | inds_e]
    if slices_wb is not None:
        sl = slices_wb[:, :, None]
        sets = [x | sl for x in sets] + [new_inds_b, new_inds_b & ~sl]
    widths = _widths(sets, log2d_w32, uniform_log2, dtype, sp)
    ev = dict(a=a, c=c, e=e, c0b=c0b, c1b=c1b, inds_b=inds_b,
              new_inds_b=new_inds_b, l_a=l_a, l_b=l_b, ln_b=widths[0],
              ln_a=widths[1])
    if slices_wb is not None:
        ev['new_width_b'], ev['new_sliced_width_b'] = widths[2:]
    nbrs = torch.cat([a, c, d, e, gp, uncle, rc[w], rc[w + 1], r0[w],
                      r0[w + 1], r1[w], r1[w + 1]], dim=1).contiguous()
    return ev, nbrs


def _accept(ev, lt, u, beta, prob_kind):
    """The accept rule at every proposal (``beta``: a scalar, or ``[B]``
    per lane); the root's proposal is always rejected."""
    if beta.dim():
        beta = beta[:, None]
    if prob_kind == 'mh':
        delta = costs_ops.delta_log2_local(lt[:, None], ev['l_a'],
                                           ev['l_b'], ev['ln_a'],
                                           ev['ln_b'])
        accept = torch.log2(u) <= -beta * delta
    elif prob_kind == 'mh_local':
        # Metropolis on the pair ratio: the move changes exactly the two
        # costs {A, B}, so judging it against their sum anneals every
        # scale of the tree at once.
        m = torch.maximum(torch.maximum(ev['l_a'], ev['l_b']),
                          torch.maximum(ev['ln_a'], ev['ln_b']))
        old = torch.exp2(ev['l_a'] - m) + torch.exp2(ev['l_b'] - m)
        new = torch.exp2(ev['ln_a'] - m) + torch.exp2(ev['ln_b'] - m)
        delta = (torch.log2(torch.clamp(new, min=_SCALED_FLOOR)) -
                 torch.log2(torch.clamp(old, min=_SCALED_FLOOR)))
        accept = torch.log2(u) <= -beta * delta
    elif prob_kind == 'greedy':
        delta = costs_ops.delta_log2_local(lt[:, None], ev['l_a'],
                                           ev['l_b'], ev['ln_a'],
                                           ev['ln_b'])
        accept = delta <= 0.0
    else:
        accept = torch.ones_like(ev['a'], dtype=torch.bool)
    return accept & (ev['a'] != NULL)


def _luby_keep(accept, bits, nbrs, n, nl):
    """Random-priority independent-set selection over ``[B, NI]``: one K1
    read of the accepted priorities at the 12 neighbours."""
    b_dim, ni = accept.shape
    ids = torch.arange(nl, n, dtype=torch.int32, device=accept.device)
    prio = (bits & _PRIO_RAND_MASK) | ids[None]
    r_acc = torch.where(accept, prio, NULL)
    r_full = torch.cat([torch.full((b_dim, nl), NULL, dtype=torch.int32,
                                   device=accept.device), r_acc], dim=1)
    rn = gather_gbn(r_full[None], nbrs)[0]
    rn = torch.where(nbrs == NULL, NULL, rn)
    r_max = rn.reshape(b_dim, 12, ni).amax(dim=1)
    return accept & (r_acc > r_max)


def _apply(S, ev, kept, w, nl, dtype, width_plane=False):
    """Applies the kept (pairwise disjoint) moves in place on ``S`` by
    pulls: every row resolves its own role from four K1 reads at aligned
    id arrays (the kept moves at its children, the parent rows, the kept
    ``e`` at the sibling and at the parent); there is no scatter.
    Role exclusivity follows from the disjointness of the kept sets."""
    nk = _nk(dtype)
    b_dim, n = S.shape[1], S.shape[2]
    dev = S.device
    x_ids = torch.arange(n, dtype=torch.int32, device=dev).expand(b_dim, n)
    c0_all, c1_all, par_all = S[w], S[w + 1], S[w + 2]
    lcc_all = _join_f(S[w + 3:w + 3 + nk], dtype)

    null_pad = torch.full((b_dim, nl), NULL, dtype=torch.int32, device=dev)

    def pad_i(vals):
        return torch.cat([null_pad, torch.where(kept, vals, NULL)], dim=1)

    e_pad = pad_i(ev['e'])
    c_pad = pad_i(ev['c'])
    ln_a_pad = torch.cat([torch.zeros((b_dim, nl), dtype=dtype, device=dev),
                          ev['ln_a']], dim=1)

    # A-role pull: does one of my children host a kept proposal?  (K1
    # reads NULL ids as 0, so the masks test the id too.)
    pull = torch.cat([e_pad[None], c_pad[None], _split_f(ln_a_pad)])
    gA = gather_gbn(pull.contiguous(), torch.cat([c0_all, c1_all], dim=1))
    e0, e1 = gA[0, :, :n], gA[0, :, n:]
    cv0, cv1 = gA[1, :, :n], gA[1, :, n:]
    ln0 = _join_f(gA[2:2 + nk, :, :n], dtype)
    ln1 = _join_f(gA[2:2 + nk, :, n:], dtype)
    kept0 = (c0_all != NULL) & (e0 != NULL)
    kept1 = (c1_all != NULL) & (e1 != NULL)
    is_a = kept0 | kept1
    e_x = torch.where(kept0, e0, e1)
    c_x = torch.where(kept0, cv0, cv1)
    ln_x = torch.where(kept0, ln0, ln1)

    # C/E-role pulls: the sibling (through the parent row) and the parent.
    par_c = par_all.contiguous()
    c0p, c1p, gp_x = gather_gbn(S, par_c, planes=(w, w + 3))
    sib = torch.where(c0p == x_ids, c1p, c0p)
    sib = torch.where(par_all == NULL, NULL, sib)
    ep_sib = gather_gbn(e_pad[None], sib)[0]
    ep_par = gather_gbn(e_pad[None], par_c)[0]
    is_c = (sib != NULL) & (ep_sib != NULL)
    is_e = (par_all != NULL) & (ep_par == x_ids)

    # B-role rows (the aligned slice of internal nodes).
    new_c0b = torch.where(ev['c0b'] == ev['e'], ev['c'], ev['c0b'])
    new_c1b = torch.where(ev['c1b'] == ev['e'], ev['c'], ev['c1b'])
    c0_new = torch.where(is_a & (c0_all == c_x), e_x, c0_all)
    c0_new[:, nl:] = torch.where(kept, new_c0b, c0_new[:, nl:])
    c1_new = torch.where(is_a & (c1_all == c_x), e_x, c1_all)
    c1_new[:, nl:] = torch.where(kept, new_c1b, c1_new[:, nl:])
    par_new = torch.where(is_c, sib, torch.where(is_e, gp_x, par_all))
    lcc_new = torch.where(is_a, ln_x, lcc_all)
    lcc_new[:, nl:] = torch.where(kept, ev['ln_b'], lcc_new[:, nl:])
    inds_new = torch.where(kept[None], ev['new_inds_b'], ev['inds_b'])
    if width_plane:
        wp = slice(w + 3 + nk, w + 3 + 2 * nk)
        width_new = torch.where(kept, ev['new_width_b'],
                                _join_f(S[wp, :, nl:], dtype))

    S[:w, :, nl:] = inds_new
    S[w] = c0_new
    S[w + 1] = c1_new
    S[w + 2] = par_new
    S[w + 3:w + 3 + nk] = _split_f(lcc_new)
    if width_plane:
        S[wp, :, nl:] = _split_f(width_new)


def draw_round(generator, b: int, ni: int, dtype=torch.float32) -> dict:
    """One round's draws on the generator's device, one call per stream:
    the accept uniforms ``u [B, NI]`` and ``bits [B, NI]`` int32 (bit 31
    the D/E tie bit, bits 30..15 the Luby priority).  torch's generator
    gives other numbers than the JAX package's threefry keys; tests
    inject those instead."""
    dev = generator.device
    return {'u': torch.rand((b, ni), generator=generator, device=dev,
                            dtype=dtype),
            'bits': torch.randint(-2**31, 2**31, (b, ni), generator=generator,
                                  device=dev, dtype=torch.int32)}


def _start(batch, cfg, betas, draws, generator, floats):
    """Checks, and the batch as the lockstep engines' plane state
    (:func:`~tnco_tpu_torch.kernels.sa_batched._pack_state` with the
    float rows ``floats``): ``(w, st, betas)``."""
    from tnco_tpu_torch.kernels import sa_batched as sb

    if cfg.prob_kind not in PROB_KINDS:
        raise ValueError(f"Unknown prob_kind: {cfg.prob_kind!r}")
    dev = batch.c0.device
    n, b = batch.c0.shape
    betas = torch.as_tensor(betas).to(device=dev, dtype=batch.lcc.dtype)
    k = betas.shape[0]
    if not k:
        raise ValueError('betas must hold at least one round.')
    if draws is not None:
        ni = n - cfg.n_leaves
        spec = {'u': ((k, b, ni), 'float'), 'bits': ((k, b, ni), 'int')}
        if 'width' in floats:
            spec['jitter'] = ((k, cfg.n_lanes * 32, b), 'float')
        sb.check_draws(draws, spec, dev)
    elif generator is None:
        raise ValueError('Pass draws= or generator=.')
    w, st = sb._pack_state(batch, floats)
    return w, st, betas


def _round(S, lt, beta, dr, log2d_w32, cfg, uniform_log2, sp, slices=None,
           max_width=None):
    """One synchronous round in place on ``S``; returns the kept moves
    ``[B, NI]``.  With ``slices`` a move must also fit ``max_width``
    after them."""
    w, nl = cfg.n_lanes, cfg.n_leaves
    dtype = log2d_w32.dtype
    ev, nbrs = _propose(S, dr['bits'], cfg, log2d_w32, uniform_log2, dtype,
                        sp, slices)
    accept = _accept(ev, lt, dr['u'], beta, cfg.prob_kind)
    if slices is not None:
        from tnco_tpu_torch.kernels.sa_finite import _WIDTH_EPS
        accept = accept & (ev['new_sliced_width_b'] <= max_width + _WIDTH_EPS)
    kept = _luby_keep(accept, dr['bits'], nbrs, S.shape[2], nl)
    _apply(S, ev, kept, w, nl, dtype, width_plane=slices is not None)
    return kept


def run_fullsweep(batch, betas, log2d_w32, cfg, sparse_wb=None,
                  log2_n_projs=None, *, uniform_log2=None, draws=None,
                  generator=None):
    """One synchronous full-tree round per beta, on the batch's device; the
    batch itself is not modified.

    Proposals per round: ``NI * B`` (every internal node).  ``betas``:
    ``[K]``, or ``[K, B]`` one beta per lane.  ``uniform_log2``: the
    common log2 dim (:func:`uniform_log2_dim`) for the popcount widths,
    as the JAX runner passes it (integer or not).  ``sparse_wb`` and
    ``log2_n_projs``: the sparse cost model's cap.  ``draws``: ``{'u':
    [K, B, NI], 'bits': [K, B, NI]}``, else :func:`draw_round` from
    ``generator`` each round.  The min snapshot is a select, with no
    host sync.  Returns the new
    :class:`~tnco_tpu_torch.kernels.sa_batched.SABatch` and ``{'moves',
    'applied'}`` (int64 tensors)."""
    from tnco_tpu_torch.kernels import sa_batched as sb

    w, st, betas = _start(batch, cfg, betas, draws, generator, ('lcc',))
    S, dtype, nl = st['planes'], st['dtype'], cfg.n_leaves
    sp = sb.sparse_args(sparse_wb, log2_n_projs)
    b, n = S.shape[1], S.shape[2]
    lt = sb._lt(S, w, nl, dtype)
    applied = torch.zeros((), dtype=torch.int64, device=S.device)
    for i in range(betas.shape[0]):
        dr = ({k: x[i] for k, x in draws.items()} if draws is not None else
              draw_round(generator, b, n - nl, dtype))
        applied += _round(S, lt, betas[i], dr, log2d_w32, cfg, uniform_log2,
                          sp).sum()
        lt = sb._lt(S, w, nl, dtype)
        sb._snapshot_min(st, lt, w)
    fields, (lcc,) = sb._unpack_state(st, w, 1)
    out = sb.SABatch(lcc=lcc, log2_total=lt, keys=batch.keys.clone(),
                     **fields)
    moves = torch.tensor(betas.shape[0] * (n - nl) * b, dtype=torch.int64)
    return out, {'moves': moves, 'applied': applied}


def run_fullsweep_fw(batch, betas, update_slices_mask, max_width, log2d_w32,
                     skip_wb, cfg, sparse_wb=None, log2_n_projs=None, *,
                     uniform_log2=None, draws=None, generator=None):
    """Width-capped synchronous rounds (one per beta), on the batch's
    device; the batch itself is not modified.

    A proposal must fit ``max_width`` after the replica's slices (the
    ``fits`` test joins the accept rule); every cost carries the slices.
    After round ``k`` where ``update_slices_mask[k]`` and some replica
    holds slices (the JAX engine's global condition, read here with one
    host sync), the greedy slicer
    (:func:`~tnco_tpu_torch.kernels.sa_finite_batched._greedy_slices_b`)
    re-derives each replica's slices and keeps them where the total
    improves.  ``draws`` adds ``jitter [K, W * 32, B]``, the slicer's
    jitter; from ``generator``, each round draws :func:`draw_round` and,
    on a reslice round, the jitter.  ``skip_wb``: int32 ``[W]`` lanes
    never sliced.  Returns the new
    :class:`~tnco_tpu_torch.kernels.sa_finite_batched.SABatchFW` and
    ``{'moves', 'applied'}``."""
    from tnco_tpu_torch.kernels import sa_batched as sb
    from tnco_tpu_torch.kernels import sa_finite_batched as sfb

    w, st, betas = _start(batch, cfg, betas, draws, generator,
                          ('lcc', 'width'))
    S, dtype, nl = st['planes'], st['dtype'], cfg.n_leaves
    nk = _nk(dtype)
    k = betas.shape[0]
    mask = np.asarray(update_slices_mask, dtype=bool).reshape(-1)
    if mask.shape[0] != k:
        raise ValueError('betas and update_slices_mask must hold one entry '
                         'per round.')
    sp = sb.sparse_args(sparse_wb, log2_n_projs)
    b, n = S.shape[1], S.shape[2]
    dev = S.device
    max_width = torch.as_tensor(max_width, dtype=dtype, device=dev)
    skip_w = skip_wb.reshape(-1)
    st['slices'] = batch.slices.clone()
    st['min_slices'] = batch.min_slices.clone()
    lt = sb._lt(S, w, nl, dtype)
    applied = torch.zeros((), dtype=torch.int64, device=dev)
    lcc_pl = slice(w + 3, w + 3 + nk)
    for i in range(k):
        dr = ({name: x[i] for name, x in draws.items()} if draws is not None
              else draw_round(generator, b, n - nl, dtype))
        applied += _round(S, lt, betas[i], dr, log2d_w32, cfg, uniform_log2,
                          sp, st['slices'], max_width).sum()
        if mask[i] and draws is None:
            dr['jitter'] = torch.rand((w * 32, b), generator=generator,
                                      device=dev, dtype=dtype)
        if mask[i] and bool((st['slices'] != 0).any()):
            c0, c1 = S[w].T, S[w + 1].T
            inds = S[:w].permute(2, 0, 1)
            width = _join_f(S[w + 3 + nk:w + 3 + 2 * nk], dtype).T
            new_slices = sfb._greedy_slices_b(
                c0, inds, width, dr['jitter'], max_width, log2d_w32, skip_w,
                **sp, uniform_log2=uniform_log2)
            new_lcc = sfb._lcc_fw_b(c0, c1, inds, new_slices, log2d_w32,
                                    **sp, uniform_log2=uniform_log2)
            better = (costs_ops.log2_total_from_lcc(new_lcc, nl) <
                      sb._lt(S, w, nl, dtype))
            st['slices'] = torch.where(better[None], new_slices,
                                       st['slices'])
            S[lcc_pl] = torch.where(better[:, None], _split_f(new_lcc.T),
                                    S[lcc_pl])
        lt = sb._lt(S, w, nl, dtype)
        sb._snapshot_min(st, lt, w)
    fields, (lcc, width) = sb._unpack_state(st, w, 2)
    out = sfb.SABatchFW(lcc=lcc, width=width, slices=st['slices'],
                        min_slices=st['min_slices'], log2_total=lt,
                        keys=batch.keys.clone(), **fields)
    moves = torch.tensor(k * (n - nl) * b, dtype=torch.int64)
    return out, {'moves': moves, 'applied': applied}

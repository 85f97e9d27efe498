"""Infinite-memory batch state, its host initializer, widths and totals,
and the lockstep 'batched' engine (from ``tnco_tpu/kernels/
sa_batched.py``: ``SABatch`` :31-69, ``init_batch`` :71-177,
``_width_b`` :208-250, ``_log2_total_b`` :253-256, ``compute_hyper_b``
:259-267, ``_sweep_batched`` :270-438, ``_run`` :441-467,
``_stream_iter`` and ``_run_stream`` :474-656).

Layout is the reference's replica-minor one (replica axis LAST; ``keys``
replica-first), with ``uint32`` words held as ``int32`` bit patterns.

The lockstep engine walks every replica from a random leaf to the root
at once, one uncle-swap proposal per walk step (reference
infinite_memory/optimizer.hpp:117-192).  The JAX engine reads and writes
rows through one-hot masks over ``N`` (the TPU's cheap direction); this
port holds a sweep's state as ``[F, B, N]`` planes, reads the rows of
every replica with the row gather K1 (ids outside ``[0, N)`` read 0, as
the masked sums do) and writes the accepted rows with the row scatter
K3 (-1 for the rest).  Both forms were measured on the card against
``gather``/``scatter_`` on the reference layout (PERF.md).
Integer and bit state equal the JAX engine's bitwise on the same state
and draws; totals agree within the float bound of ``exp2``/``log2``
(tests inject the JAX draws through ``draws=``).
"""

from dataclasses import dataclass, fields

import numpy as np
import torch

from tnco_tpu_torch.device import resolve_device
from tnco_tpu_torch.kernels.gather import gather_gbn
from tnco_tpu_torch.kernels.scatter import scatter_rows_inplace
from tnco_tpu_torch.kernels.sa_fullsweep import (_join_f, _nk, _split_f,
                                                  _width_bn)
from tnco_tpu_torch.ops import costs as costs_ops
from tnco_tpu_torch.ops import rng

__all__ = ['SABatch', 'init_batch', 'from_states', 'replica_state',
           'compute_hyper_b', 'run_sweeps_batched', 'run_sweeps_per_replica',
           'run_stream_batched', 'draw_sweep', 'draw_stream',
           'max_walk_steps', 'sparse_args', 'NULL']

NULL = -1
_PROB_KINDS = ('mh', 'greedy', 'base')
# A sweep's walk loop asks the card whether any replica is still walking
# once every this many steps (steps with none walking change nothing).
ACTIVE_CHECK_STEPS = 8


@dataclass
class SABatch:
    """Replica-minor infinite-memory state (torch tensors on one device).

    ``c0/c1/par: int32 [N, B]``; ``inds/hyper/min_inds: int32 [N, W, B]``
    bit patterns; ``lcc: float [N, B]`` (log2 contraction costs, -inf at
    leaves); ``log2_total/min_log2_total: float [B]``; ``keys: int32
    [B, 2]`` (the replicas' seed words, carried for the layout; draws come
    from a ``torch.Generator``).
    """
    c0: torch.Tensor
    c1: torch.Tensor
    par: torch.Tensor
    inds: torch.Tensor
    hyper: torch.Tensor
    lcc: torch.Tensor
    log2_total: torch.Tensor
    min_log2_total: torch.Tensor
    min_c0: torch.Tensor
    min_c1: torch.Tensor
    min_par: torch.Tensor
    min_inds: torch.Tensor
    keys: torch.Tensor

    @classmethod
    def field_names(cls):
        return tuple(f.name for f in fields(cls))


def init_batch(ctrees, seeds, log2_dims_padded, *, sparse_lanes=None,
               log2_n_projs=None, dtype=np.float32, device=None) -> SABatch:
    """Builds a replica-minor batch on the host (numpy) and uploads it
    once to ``device`` (None means the card; without CUDA that raises,
    and a host run passes ``device='cpu'``).

    Same arithmetic as the JAX package's ``init_batch`` (float64 word by
    word, then cast), so every field equals it bitwise.  The reference
    computes the caches once per unique tree and broadcasts them; this
    computes them per replica, with the same result.  ``sparse_lanes``
    (``uint32 [W]``) and ``log2_n_projs``: the sparse cost model's cap
    on the sparse part of every cost.
    """
    dev = resolve_device(device)
    n = len(ctrees[0])
    n_leaves = ctrees[0].n_leaves
    b = len(ctrees)
    w = ctrees[0].inds_array.shape[1]
    log2d = np.asarray(log2_dims_padded, dtype=np.float64)

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

    internal = c0 >= 0
    c0s = np.where(internal, c0, 0)
    c1s = np.where(internal, c1, 0)
    inds_c0 = np.take_along_axis(inds, c0s[:, None, :], axis=0)
    inds_c1 = np.take_along_axis(inds, c1s[:, None, :], axis=0)
    hyper = np.where(internal[:, None, :], inds & inds_c0 & inds_c1,
                     np.uint32(0))

    # log2 cost per node: width of the union of the children (sparse
    # part capped), word by word (one [N, W, 32, B] float64 expansion
    # would be GBs at scale).
    union = inds_c0 | inds_c1
    shifts = np.arange(32, dtype=np.uint32)
    log2d_w32 = log2d.reshape(w, 32)

    def w_of(lanes_nwb):
        out = np.zeros((n, b), dtype=np.float64)
        for word in range(w):
            bits = ((lanes_nwb[:, word, None, :] >>
                     shifts[None, :, None]) & 1).astype(np.float64)
            out += np.einsum('nsb,s->nb', bits, log2d_w32[word])
        return out

    if sparse_lanes is None:
        lcc = w_of(union)
    else:
        sp = np.asarray(sparse_lanes, dtype=np.uint32)[None, :, None]
        lcc = w_of(union & ~sp) + np.minimum(w_of(union & sp),
                                             float(log2_n_projs))
    lcc = np.where(internal, lcc, -np.inf).astype(dtype)

    internal_lcc = lcc[n_leaves:]
    m = internal_lcc.max(axis=0)
    lt = (m + np.log2(np.exp2(internal_lcc - m[None, :]).sum(axis=0))
          ).astype(dtype)

    keys = np.stack([np.zeros(b, dtype=np.uint32),
                     np.asarray([int(s) & 0xFFFFFFFF for s in seeds],
                                dtype=np.uint32)], axis=1)

    def up(x):
        x = np.ascontiguousarray(x)
        if x.dtype == np.uint32:
            x = x.view(np.int32)
        return torch.from_numpy(x).to(dev)

    return SABatch(up(c0), up(c1), up(par), up(inds), up(hyper), up(lcc),
                   up(lt), up(lt), up(c0), up(c1), up(par), up(inds),
                   up(keys))


def from_states(states) -> SABatch:
    """Stacks single-replica ``SAStateIM`` (all on one device) into a
    replica-minor batch on that device (``sa_batched.py:179-191``)."""
    from tnco_tpu_torch.kernels import sa_infinite as sa

    return sa.to_batch(sa.stack(_one_device(states)))


def replica_state(batch: SABatch, i: int):
    """Replica ``i`` of ``batch`` as an ``SAStateIM``, its fields the
    batch's column ``i`` (``sa_batched.py:194-205``)."""
    from tnco_tpu_torch.kernels import sa_infinite as sa

    return sa.unstack(sa.from_batch(batch), i)


def _one_device(states):
    """``states`` as a list; raises unless it holds at least one state
    and every state lies on one device."""
    states = list(states)
    if not states:
        raise ValueError('Pass at least one state.')
    devs = {str(s.nodes.device) for s in states}
    if len(devs) > 1:
        raise ValueError(
            f'The states lie on several devices: {sorted(devs)}.')
    return states


def _width_b(lanes_wb, log2d_w32, *, sparse_wb=None, log2_n_projs=None,
             uniform_log2=None):
    """Width of ``int32 [W, ...]`` lane sets -> ``[...]``.

    Uniform dims with an integer log2 take the popcount (bitwise equal to
    the pinned tree: integer-valued float sums are exact); every other
    case takes the (w*32+s)-ordered pairwise-halving tree.  With
    ``sparse_wb`` (``int32 [W]`` or ``[W, 1]``), the sparse part is
    capped at ``log2_n_projs``.
    """
    if uniform_log2 is not None and not float(uniform_log2).is_integer():
        uniform_log2 = None
    return _width_bn(lanes_wb, log2d_w32, uniform_log2, log2d_w32.dtype,
                     sparse_w=None if sparse_wb is None else
                     sparse_wb.reshape(-1), log2_n_projs=log2_n_projs)


def _log2_total_b(lcc, n_leaves):
    """Order-pinned total over internal nodes (node axis 0)."""
    return costs_ops.log2_total_from_lcc(lcc, n_leaves)


def compute_hyper_b(c0, c1, inds):
    """Full ``hyper`` recompute: ``inds[i] & inds[c0[i]] & inds[c1[i]]``.

    ``c0/c1: int32 [N, B]``, ``inds: int32 [N, W, B]`` (bit patterns).
    The child rows are read with the row gather K1 (leaves carry NULL
    children, which gather zero rows, so their hyper rows are 0).
    """
    inds_wbn = inds.permute(1, 2, 0).contiguous()            # [W, B, N]
    inds_c0 = gather_gbn(inds_wbn, c0.T.contiguous())
    inds_c1 = gather_gbn(inds_wbn, c1.T.contiguous())
    return (inds_wbn & inds_c0 & inds_c1).permute(2, 0, 1).contiguous()


def max_walk_steps(n_leaves: int) -> int:
    """Walk steps a sweep can take at most: a walk climbs the start
    node's ancestors, which no move changes (a move at ``(a, b)`` keeps
    ``a``'s ancestors and ``b``'s parent), so a tree of ``n_leaves``
    leaves bounds it by ``n_leaves - 1``."""
    return max(int(n_leaves) - 1, 0)


def draw_sweep(generator: torch.Generator, n_leaves: int, b: int,
               dtype=torch.float32) -> dict:
    """One sweep's draws on the generator's device, one call per stream:
    ``leaf [B]`` in ``[0, n_leaves)`` (int32), ``rand_bit [T, B]`` (bool)
    and ``u [T, B]`` in ``[0, 1)``, ``T = max_walk_steps(n_leaves)``.  A
    replica's ``t``-th walk step reads row ``t``.  torch's generator gives
    other numbers than the JAX package's threefry keys; tests inject
    those instead."""
    t = max_walk_steps(n_leaves)
    return {'leaf': rng.randint(generator, 0, n_leaves, (b,), 0),
            'rand_bit': rng.randint(generator, 0, 2, (t, b), -1) != 0,
            'u': rng.rand(generator, (t, b), -1, dtype)}


def check_draws(draws: dict, spec: dict, device) -> None:
    """Raises ``ValueError`` unless ``draws`` holds each stream of
    ``spec`` (name -> (shape, 'int' | 'bool' | 'float')) on ``device``."""
    for name, (shape, kind) in spec.items():
        x = draws.get(name)
        if not isinstance(x, torch.Tensor):
            raise ValueError(f"draws[{name!r}] must be a tensor of shape "
                             f"{tuple(shape)}.")
        ok = {'int': not x.is_floating_point() and x.dtype != torch.bool,
              'bool': x.dtype == torch.bool,
              'float': x.is_floating_point()}[kind]
        if tuple(x.shape) != tuple(shape) or not ok or \
                x.device != torch.device(device):
            raise ValueError(
                f"draws[{name!r}] must be {kind} {tuple(shape)} on "
                f"{device}, got {x.dtype} {tuple(x.shape)} on {x.device}.")


def check_prob_kind(cfg) -> None:
    if cfg.prob_kind not in _PROB_KINDS:
        raise ValueError(f"Unknown prob_kind: {cfg.prob_kind!r}")


def _accept(prob_kind, log2_u, beta, l_new, l_old):
    if prob_kind == 'mh':
        return costs_ops.mh_log2_accept(log2_u, beta, l_new, l_old)
    if prob_kind == 'greedy':
        return l_new <= l_old
    return torch.ones_like(l_new, dtype=torch.bool)


# The sweeps' working state is int32 ``[F, B, N]`` planes: the W index
# words, then c0, c1, par, the lcc bits and (finite width) the
# pre-slicing width bits, each float row in ``nk`` planes (one for
# float32, two for float64: ``sa_fullsweep._split_f``).  A row of every
# plane is one read of the row gather K1, which gives 0 for ids outside
# [0, N) as the reference's masked sums do; the accepted rows are
# written by the row scatter K3.
C0, C1, PAR, LCC = range(4)


def _pack_planes(inds, ids, floats):
    """``inds [N, W, B]``, id rows ``[N, B]`` (c0, c1, par) and float
    rows ``[N, B]`` -> int32 ``[W + len(ids) + nk * len(floats), B,
    N]``."""
    rows = ([inds.permute(1, 2, 0)] + [x.T[None] for x in ids] +
            [_split_f(x.T) for x in floats])
    return torch.cat(rows).contiguous()


def _unpack(planes, w):
    """``(inds [N, W, B], c0, c1, par)`` of a plane state (copies)."""
    return (planes[:w].permute(2, 0, 1).contiguous(),
            *(planes[w + k].T.contiguous() for k in (C0, C1, PAR)))


def _read(planes, ids, lo=0, hi=None):
    """Rows ``ids [B]`` of planes ``lo..hi``: ``[hi - lo, B]`` (K1)."""
    hi = planes.shape[0] if hi is None else hi
    return gather_gbn(planes, ids[:, None].to(torch.int32).contiguous(),
                      planes=(lo, hi))[..., 0]


def _write(planes, ids, upd, ok, lo=0):
    """In place, with the row scatter K3: ``planes[lo + g, b, ids[b, q]]
    = upd[g, b, q]`` where ``ok[b]`` (the other replicas' ids become -1,
    which writes nothing)."""
    scatter_rows_inplace(planes, torch.where(ok[:, None], ids, NULL),
                         upd.contiguous(), planes=(lo, lo + upd.shape[0]))


def _propose(planes, w, b, rand_bit, disable_shared_inds,
             dtype=torch.float32):
    """The uncle swap at node ``b [B]`` of every replica (reads only):
    ``a`` = parent, ``c`` = sibling, ``e`` = the child of ``b`` that
    trades places with ``c``; ``d`` stays.  Three K1 reads: row ``b``,
    row ``a``, and the index rows of ``c`` and ``b``'s children.  Returns
    the ids, ``new_inds_b`` (hyper rows on the fly: ``hyper[i] = inds[i]
    & inds[c0] & inds[c1]``) and the new rows of ``a`` and ``b`` but for
    their costs: ``upd [F, B, 2]``.  ``dtype``: the state's float type
    (its ``nk`` lcc planes)."""
    nk = _nk(dtype)
    rb = _read(planes, b)
    a = rb[w + PAR]
    ra = _read(planes, a)
    c0b, c1b = rb[w + C0], rb[w + C1]
    c = torch.where(ra[w + C0] == b, ra[w + C1], ra[w + C0])
    inds_c, inds0, inds1 = gather_gbn(
        planes, torch.stack([c, c0b, c1b], 1), planes=(0, w)).unbind(2)
    i0 = ((inds0 & inds_c) != 0).any(dim=0)
    i1 = ((inds1 & inds_c) != 0).any(dim=0)
    take0 = rand_bit if disable_shared_inds else torch.where(i0 & i1,
                                                             rand_bit, i0)
    e = torch.where(take0, c1b, c0b)
    inds_d = torch.where(take0, inds0, inds1)
    inds_e = torch.where(take0, inds1, inds0)
    inds_a, inds_b = ra[:w], rb[:w]
    new_inds_b = ((inds_d ^ inds_c) | (inds_a & inds_b & inds_c) |
                  (inds_b & inds0 & inds1))
    # Rows a and b trade c for e; b's parent stays a.
    upd = torch.stack([ra, rb], dim=2)
    ids = upd[w + C0:w + PAR]
    upd[w + C0:w + PAR] = torch.where(
        ids == c[:, None], e[:, None],
        torch.where(ids == e[:, None], c[:, None], ids))
    upd[:w, :, 1] = new_inds_b
    return dict(b=b, a=a, c=c, e=e, inds_c=inds_c, inds_d=inds_d,
                inds_e=inds_e, new_inds_b=new_inds_b, upd=upd,
                l_a=_join_f(ra[w + LCC:w + LCC + nk], dtype),
                l_b=_join_f(rb[w + LCC:w + LCC + nk], dtype))


def _apply(planes, w, p, ok, ln_a, ln_b):
    """Writes the swaps of the replicas in ``ok``: rows a and b with
    their costs ``ln_a``, ``ln_b`` (and whatever else ``p['upd']``
    holds), then ``par[c] = b``, ``par[e] = a``."""
    upd = p['upd']
    nk = _nk(ln_a.dtype)
    upd[w + LCC:w + LCC + nk] = _split_f(torch.stack([ln_a, ln_b], 1))
    _write(planes, torch.stack([p['a'], p['b']], 1), upd, ok)
    _write(planes, torch.stack([p['c'], p['e']], 1),
           torch.stack([p['b'], p['a']], 1)[None], ok, lo=w + PAR)


def _widths(lane_sets, log2d_w32, uniform_log2, sp):
    """Widths of several ``[W, B]`` lane sets in one pass: ``[k, B]``
    (elementwise over the stacked sets, so each equals its own call).
    ``sp``: ``{'sparse_wb', 'log2_n_projs'}`` of the cost model."""
    return _width_b(torch.stack(lane_sets, 1), log2d_w32,
                    uniform_log2=uniform_log2, **sp)


def _lt(planes, w, n_leaves, dtype=torch.float32):
    """Order-pinned total of the lcc planes (node axis last)."""
    return costs_ops.log2_total_from_lcc_last(
        _join_f(planes[w + LCC:w + LCC + _nk(dtype)], dtype), n_leaves)


def _par_of(planes, w, pos):
    return _read(planes, pos, w + PAR, w + PAR + 1)[0]


def _snapshot_min(st, lt, w, where=None):
    """The min snapshot of the replicas whose total ``lt`` improved on
    their min (only those in ``where``, if given), in place: the tree
    planes and, finite width, the slices."""
    improved = lt < st['min_lt']
    if where is not None:
        improved = improved & where
    st['min_lt'] = torch.where(improved, lt, st['min_lt'])
    st['min_planes'] = torch.where(improved[:, None],
                                   st['planes'][:w + PAR + 1],
                                   st['min_planes'])
    if 'slices' in st:
        st['min_slices'] = torch.where(improved, st['slices'],
                                       st['min_slices'])


def _pack_state(batch, floats):
    """A batch's sweep state: planes of the current tree with ``floats``
    (field names), the min tree planes, the min total and the float
    type."""
    w = batch.inds.shape[1]
    return w, {'dtype': batch.lcc.dtype,
               'planes': _pack_planes(batch.inds, (batch.c0, batch.c1,
                                                  batch.par),
                                     [getattr(batch, f) for f in floats]),
               'min_planes': _pack_planes(batch.min_inds,
                                         (batch.min_c0, batch.min_c1,
                                          batch.min_par), []),
               'min_lt': batch.min_log2_total.clone()}


def _unpack_state(st, w, n_floats):
    """The SABatch fields of a sweep state (``hyper`` refreshed by K1)."""
    inds, c0, c1, par = _unpack(st['planes'], w)
    m_inds, m_c0, m_c1, m_par = _unpack(st['min_planes'], w)
    dtype = st['dtype']
    nk = _nk(dtype)
    floats = [_join_f(st['planes'][w + LCC + k * nk:w + LCC + (k + 1) * nk],
                      dtype).T.contiguous() for k in range(n_floats)]
    return dict(c0=c0, c1=c1, par=par, inds=inds,
                hyper=compute_hyper_b(c0, c1, inds), min_c0=m_c0,
                min_c1=m_c1, min_par=m_par, min_inds=m_inds,
                min_log2_total=st['min_lt']), floats


def _sweep(st, w, beta, log2d_w32, cfg, dr, uniform_log2, sp):
    """One lockstep leaf-to-root sweep of every replica, in place on
    ``st``; returns ``(log2 total, walk steps per replica [B])``."""
    planes, dtype = st['planes'], st['dtype']
    lt = _lt(planes, w, cfg.n_leaves, dtype)
    leaf = dr['leaf']
    pos_b = torch.where(leaf == NULL, NULL, _par_of(planes, w, leaf))
    par_b0 = torch.where(pos_b == NULL, NULL, _par_of(planes, w, pos_b))
    active = (pos_b != NULL) & (par_b0 != NULL)
    moves = torch.zeros(active.shape, dtype=torch.int32,
                        device=planes.device)
    for t in range(dr['rand_bit'].shape[0]):
        if t % ACTIVE_CHECK_STEPS == 0 and not bool(active.any()):
            break
        p = _propose(planes, w, pos_b, dr['rand_bit'][t],
                     cfg.disable_shared_inds, dtype)
        ln_b, ln_a = _widths((p['inds_d'] | p['inds_c'],
                              p['new_inds_b'] | p['inds_e']), log2d_w32,
                             uniform_log2, sp)
        l_new = costs_ops.new_total_log2(lt, p['l_a'], p['l_b'], ln_a, ln_b)
        accept = active & _accept(cfg.prob_kind, torch.log2(dr['u'][t]),
                                  beta, l_new, lt)
        _apply(planes, w, p, accept, ln_a, ln_b)
        lt = torch.where(accept, l_new, lt)
        pos_b = torch.where(active, p['a'], pos_b)
        moves += active
        active = active & (pos_b != NULL) & (_par_of(planes, w, pos_b) !=
                                             NULL)
    lt = _lt(planes, w, cfg.n_leaves, dtype)
    _snapshot_min(st, lt, w)
    return lt, moves


def run_sweeps_batched(batch: SABatch, betas, log2d_w32, cfg,
                       sparse_wb=None, log2_n_projs=None, *,
                       uniform_log2=None, draws=None, generator=None):
    """One lockstep sweep per beta (``_run``, ``sa_batched.py:441-467``),
    on the batch's device; the batch itself is not modified.

    ``sparse_wb`` (``int32 [W]`` or ``[W, 1]``) and ``log2_n_projs``:
    the sparse cost model's cap (every cost's sparse part at most
    ``log2_n_projs``).  ``draws`` (optional): ``{'leaf': [K, B],
    'rand_bit': [K, T, B], 'u': [K, T, B]}`` with ``T =
    max_walk_steps(cfg.n_leaves)``; without it, each sweep draws
    :func:`draw_sweep` from ``generator``.  After the chunk the stored
    ``hyper`` is refreshed with the row gather K1
    (:func:`compute_hyper_b`).  Returns the new batch and
    ``{'log2_total': [K, B], 'log2_min_total': [K, B], 'moves': [K]}``.
    """
    out, hist = run_sweeps_per_replica(batch, betas, log2d_w32, cfg,
                                       sparse_wb, log2_n_projs,
                                       uniform_log2=uniform_log2,
                                       draws=draws, generator=generator)
    hist['moves'] = hist['moves'].sum(dim=1)
    return out, hist


def run_sweeps_per_replica(batch: SABatch, betas, log2d_w32, cfg,
                           sparse_wb=None, log2_n_projs=None, *,
                           uniform_log2=None, draws=None, generator=None):
    """:func:`run_sweeps_batched` with the walk steps counted per
    replica: ``'moves'`` is ``int32 [K, B]`` (what the replica-major
    engines of :mod:`~tnco_tpu_torch.kernels.sa_infinite` report)."""
    check_prob_kind(cfg)
    dev = batch.c0.device
    b = batch.c0.shape[1]
    dtype = batch.lcc.dtype
    betas = torch.as_tensor(betas).to(device=dev, dtype=dtype)
    k = betas.shape[0]
    if not k:
        raise ValueError('betas must hold at least one sweep.')
    t = max_walk_steps(cfg.n_leaves)
    if draws is not None:
        check_draws(draws, {'leaf': ((k, b), 'int'),
                            'rand_bit': ((k, t, b), 'bool'),
                            'u': ((k, t, b), 'float')}, dev)
    elif generator is None:
        raise ValueError('Pass draws= or generator=.')
    sp = sparse_args(sparse_wb, log2_n_projs)
    w, st = _pack_state(batch, ('lcc',))
    hist = {'log2_total': [], 'log2_min_total': [], 'moves': []}
    for i in range(k):
        dr = ({name: x[i] for name, x in draws.items()} if draws is not None
              else draw_sweep(generator, cfg.n_leaves, b, dtype))
        lt, moves = _sweep(st, w, betas[i], log2d_w32, cfg, dr,
                           uniform_log2, sp)
        hist['log2_total'].append(lt)
        hist['log2_min_total'].append(st['min_lt'])
        hist['moves'].append(moves)
    fields, (lcc,) = _unpack_state(st, w, 1)
    out = SABatch(lcc=lcc, log2_total=lt, keys=batch.keys.clone(), **fields)
    return out, {name: torch.stack(v) for name, v in hist.items()}


def sparse_args(sparse_wb, log2_n_projs) -> dict:
    """The sparse cost model's engine inputs as ``_width_b`` keywords
    (``sparse_wb`` flattened to ``[W]``, ``log2_n_projs`` a float);
    both None for a dense model.  Raises unless both or neither are
    given."""
    if (sparse_wb is None) != (log2_n_projs is None):
        raise ValueError('Pass both sparse_wb and log2_n_projs, or '
                         'neither.')
    if sparse_wb is None:
        return {'sparse_wb': None, 'log2_n_projs': None}
    return {'sparse_wb': sparse_wb.reshape(-1),
            'log2_n_projs': float(log2_n_projs)}


def _stream_iter(st, w, betas, cfg, dr, uniform_log2, log2d_w32, sp):
    """One iteration of the continuous move stream (``sa_batched.py:
    474-619``), in place on ``st``: a replica at the root closes its
    sweep (min snapshot, a new leaf, the next beta) and every other
    running replica takes one walk step.  Returns the replicas walked."""
    planes, dtype = st['planes'], st['dtype']
    n_sweeps = betas.shape[0]
    running = st['sweep_cnt'] < n_sweeps
    lt = _lt(planes, w, cfg.n_leaves, dtype)
    pos_b = st['pos_b']
    at_boundary = running & ((pos_b == NULL) |
                             (_par_of(planes, w, pos_b) == NULL))
    walking = running & ~at_boundary

    _snapshot_min(st, lt, w, at_boundary)
    pos_b = torch.where(at_boundary, _par_of(planes, w, dr['leaf']), pos_b)
    st['sweep_cnt'] = torch.where(at_boundary, st['sweep_cnt'] + 1,
                                  st['sweep_cnt'])
    beta = betas[(st['sweep_cnt'] - 1).clamp(0, n_sweeps - 1).long()]

    b = torch.where(walking, pos_b, 0)
    p = _propose(planes, w, b, dr['rand_bit'], cfg.disable_shared_inds,
                 dtype)
    ln_b, ln_a = _widths((p['inds_d'] | p['inds_c'],
                          p['new_inds_b'] | p['inds_e']), log2d_w32,
                         uniform_log2, sp)
    l_new = costs_ops.new_total_log2(lt, p['l_a'], p['l_b'], ln_a, ln_b)
    accept = walking & _accept(cfg.prob_kind, torch.log2(dr['u']), beta,
                               l_new, lt)
    _apply(planes, w, p, accept, ln_a, ln_b)
    st['pos_b'] = torch.where(walking, p['a'], pos_b)
    return walking


def draw_stream(generator: torch.Generator, n_leaves: int, n_iters: int,
                b: int, dtype=torch.float32) -> dict:
    """The stream's draws: ``leaf``, ``rand_bit`` and ``u``, each
    ``[n_iters, B]``, one call per stream."""
    dev = generator.device
    return {'leaf': torch.randint(0, n_leaves, (n_iters, b),
                                  generator=generator, device=dev,
                                  dtype=torch.int32),
            'rand_bit': torch.randint(0, 2, (n_iters, b),
                                      generator=generator, device=dev,
                                      dtype=torch.int32) != 0,
            'u': torch.rand((n_iters, b), generator=generator, device=dev,
                            dtype=dtype)}


def run_stream_batched(batch: SABatch, betas, n_iters: int, log2d_w32,
                       cfg, pos_b, sweep_cnt, sparse_wb=None,
                       log2_n_projs=None, *, uniform_log2=None,
                       draws=None, generator=None):
    """``n_iters`` iterations of the continuous move stream
    (``_run_stream``, ``sa_batched.py:622-656``): every replica runs its
    own sweeps over the beta ramp, ``pos_b [B]`` and ``sweep_cnt [B]``
    carried between calls (start with ``pos_b`` all NULL and
    ``sweep_cnt`` 0).  At the end, replicas that just reached the root
    take their last min snapshot.  ``draws``: ``{'leaf', 'rand_bit',
    'u'}``, each ``[n_iters, B]`` (the JAX package feeds the leaf and
    the bit from one key); else :func:`draw_stream` from ``generator``.
    ``sparse_wb``, ``log2_n_projs``: as in :func:`run_sweeps_batched`.
    Returns the new batch and ``{'moves', 'pos_b', 'sweep_cnt'}``.
    """
    check_prob_kind(cfg)
    dev = batch.c0.device
    b = batch.c0.shape[1]
    dtype = batch.lcc.dtype
    betas = torch.as_tensor(betas).to(device=dev, dtype=dtype)
    if draws is not None:
        check_draws(draws, {'leaf': ((n_iters, b), 'int'),
                            'rand_bit': ((n_iters, b), 'bool'),
                            'u': ((n_iters, b), 'float')}, dev)
    elif generator is None:
        raise ValueError('Pass draws= or generator=.')
    else:
        draws = draw_stream(generator, cfg.n_leaves, n_iters, b, dtype)
    sp = sparse_args(sparse_wb, log2_n_projs)
    w, st = _pack_state(batch, ('lcc',))
    st['pos_b'] = torch.as_tensor(pos_b, device=dev).to(torch.int32).clone()
    st['sweep_cnt'] = torch.as_tensor(sweep_cnt, device=dev).to(
        torch.int32).clone()
    moves = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(n_iters):
        moves += _stream_iter(st, w, betas, cfg,
                              {k: x[i] for k, x in draws.items()},
                              uniform_log2, log2d_w32, sp).sum()
    lt = _lt(st['planes'], w, cfg.n_leaves, st['dtype'])
    pos_b = st['pos_b']
    at_root = (pos_b == NULL) | (_par_of(st['planes'], w, pos_b) == NULL)
    _snapshot_min(st, lt, w, at_root)
    fields, (lcc,) = _unpack_state(st, w, 1)
    out = SABatch(lcc=lcc, log2_total=lt, keys=batch.keys.clone(), **fields)
    return out, {'moves': moves, 'pos_b': pos_b,
                 'sweep_cnt': st['sweep_cnt']}

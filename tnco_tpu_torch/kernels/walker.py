"""K5: the multi-walk SA walker — the port of
``tnco_tpu/kernels/pallas_walker.py`` (``walker_supported``,
``run_walker`` / ``_run_walker``, infinite memory; ``run_walker_fw``,
``_walker_fw_segment``, ``_walker_fw_reslice``, finite width).

:func:`run_walker` runs a K-iteration chunk of ``P``-walk SA for every
replica in one launch of the hand-written kernel ``csrc/walker.cu`` (one
CTA per replica), then does the final min check and the hyper refresh
through K1.  Its results equal :func:`run_walker_plain`, the plain
PyTorch version (the multi-walk engine
:func:`~tnco_tpu_torch.kernels.sa_multiwalk.run_multiwalk`), bitwise on
the same draws, as the TPU walker's results equal ``run_multiwalk``'s.
The draws are drawn before the launch, ``[K, P, B]`` each, and both
versions consume the same tensors.

:func:`run_walker_fw` is the finite-width walker: the chunk is split
after every reslice point of the mask, each piece is one launch of the
kernel's FW form (:func:`walker_fw_segment`), and the greedy
reslice-if-better runs between launches on the packed rows
(:func:`walker_fw_reslice`).  The state is packed once per chunk.  Its
results equal :func:`run_walker_fw_plain` (the multi-walk engine
:func:`~tnco_tpu_torch.kernels.sa_multiwalk.run_multiwalk_fw`) bitwise
on the same draws.

A CUDA batch launches the kernel or raises; a CPU batch takes the plain
version.  No fallback.
"""

import numpy as np
import torch

from tnco_tpu_torch.kernels import build
from tnco_tpu_torch.kernels import sa_multiwalk as smw
from tnco_tpu_torch.kernels.sa_batched import _log2_total_b
from tnco_tpu_torch.utils.profiling import count, host_read, span

__all__ = ['walker_supported', 'walker_supported_fw', 'run_walker',
           'run_walker_plain', 'run_walker_fw', 'run_walker_fw_plain']

MAX_WALKS = 128           # the TPU kernel's 128 walk lanes
_HDR = 4                  # row header: c0, c1, par, lcc bits
_C0, _C1, _PAR, _LCC = 0, 1, 2, 3
_WPRE, _HDR_FW = 4, 5     # FW header: + the pre-slicing width bits
_PROB_KIND = {'mh': 0, 'greedy': 1, 'base': 2}
_NEG_INF_BITS = int(torch.tensor(-float('inf')).view(torch.int32))


def walker_supported(n: int, n_leaves: int, w: int) -> bool:
    """Where the walker runs (``pallas_walker.py:59-60``): at most 124
    index words, at least one internal node, fewer than 30000 nodes (the
    lcc column of one replica lives in shared memory)."""
    return w + _HDR <= 128 and n - n_leaves > 0 and n < 30000


def walker_supported_fw(n: int, n_leaves: int, w: int) -> bool:
    """Where the FW walker runs: as :func:`walker_supported`, with one
    header word more (at most 123 index words, as the TPU rows' 128
    lanes allow)."""
    return w + _HDR_FW <= 128 and n - n_leaves > 0 and n < 30000


def _pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def row_words(w: int) -> int:
    """Words per row: the header and ``W`` index words, rounded up to a
    multiple of 4 (16-byte rows: the snapshot copies 16-byte words)."""
    return _HDR + -(-w // 4) * 4


def pack_rows(c0, c1, par, lcc, inds):
    """``[N, B]`` / ``[N, W, B]`` tensors -> ``int32 [B, N, R]`` rows:
    c0, c1, par, lcc bits, the index words, zero padding."""
    n, w, b = inds.shape
    rows = torch.zeros((b, n, row_words(w)), dtype=torch.int32,
                       device=c0.device)
    rows[:, :, _C0] = c0.T
    rows[:, :, _C1] = c1.T
    rows[:, :, _PAR] = par.T
    rows[:, :, _LCC] = lcc.T.view(torch.int32)
    rows[:, :, _HDR:_HDR + w] = inds.permute(2, 0, 1)
    return rows


def unpack_rows(rows, w: int):
    """Inverse of :func:`pack_rows`: ``c0, c1, par, lcc, inds``."""
    c0 = rows[:, :, _C0].T.contiguous()
    c1 = rows[:, :, _C1].T.contiguous()
    par = rows[:, :, _PAR].T.contiguous()
    lcc = rows[:, :, _LCC].T.contiguous().view(torch.float32)
    inds = rows[:, :, _HDR:_HDR + w].permute(1, 2, 0).contiguous()
    return c0, c1, par, lcc, inds


def _check(batch, cfg, n_walks, pos, log2d_w32, fw=False):
    n, b = batch.c0.shape
    w = batch.inds.shape[1]
    supported = walker_supported_fw if fw else walker_supported
    if not supported(n, cfg.n_leaves, w):
        raise ValueError(
            f"The walker does not run on N={n}, n_leaves={cfg.n_leaves}, "
            f"W={w} ({supported.__name__}: W <= {123 if fw else 124}, an "
            "internal node, N < 30000).")
    if not 1 <= n_walks <= MAX_WALKS:
        raise ValueError(f"n_walks must be in [1, {MAX_WALKS}], got "
                         f"{n_walks}.")
    if tuple(pos.shape) != (n_walks, b) or pos.dtype != torch.int32:
        raise ValueError(f"pos must be int32 [{n_walks}, {b}], got "
                         f"{tuple(pos.shape)} {pos.dtype}.")
    if tuple(log2d_w32.shape) != (w, 32):
        raise ValueError(f"log2d_w32 must be [{w}, 32], got "
                         f"{tuple(log2d_w32.shape)}.")
    smw.check_options(cfg)
    float32_only(log2d_w32.dtype)
    if batch.c0.device.type not in ('cpu', 'cuda'):
        raise ValueError(f"Unsupported device: {batch.c0.device}.")


def run_walker_plain(batch, betas, log2d_w32, cfg, n_walks: int, pos, *,
                     draws=None, generator=None):
    """Plain PyTorch version of :func:`run_walker` (the CPU route, and
    the kernel's yardstick on the card): the multi-walk engine."""
    _check(batch, cfg, n_walks, pos, log2d_w32)
    return smw.run_multiwalk(batch, betas, log2d_w32, cfg, n_walks, pos,
                             draws=draws, generator=generator)


def launch_walker(rows, min_rows, pos_bp, min_lt, applied, draws, betas,
                  log2d, cfg, n: int, w: int, lib=None):
    """One K5 launch on packed buffers, updated in place (no counting:
    :func:`run_walker` counts, and timing code calls this directly).
    ``lib``: the kernels' library (default :func:`build.load`; the
    profiling script passes a build of :func:`build.load_walker`)."""
    b, _, r = rows.shape
    k, p = draws['leaf'].shape[:2]
    lib = lib or build.load()
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    rc = lib.tnco_walker_im(
        rows.data_ptr(), min_rows.data_ptr(), pos_bp.data_ptr(),
        min_lt.data_ptr(), applied.data_ptr(), draws['leaf'].data_ptr(),
        draws['rand_bit'].data_ptr(), draws['u'].data_ptr(),
        betas.data_ptr(), log2d.data_ptr(), b, n, cfg.n_leaves, w, r, p, k,
        _pow2(n - cfg.n_leaves), _PROB_KIND[cfg.prob_kind],
        int(cfg.disable_shared_inds), stream)
    build.check(rc, 'walker_im')


def kernel_inputs(batch, betas, log2d_w32, pos, draws):
    """The kernel's operands, packed and checked: ``rows``, ``min_rows``,
    ``pos [B, P]``, ``min_lt``, ``applied [B]``, the draws as contiguous
    ``[K, P, B]`` int32/float32, ``betas [K]`` and ``log2d [W * 32]``."""
    dev = batch.c0.device
    rows = pack_rows(batch.c0, batch.c1, batch.par, batch.lcc, batch.inds)
    min_rows = pack_rows(batch.min_c0, batch.min_c1, batch.min_par,
                         torch.zeros_like(batch.lcc), batch.min_inds)
    k = betas.shape[0]
    shape = (k,) + tuple(pos.shape)
    dr = {'leaf': draws['leaf'].to(torch.int32).contiguous(),
          'rand_bit': draws['rand_bit'].to(torch.int32).contiguous(),
          'u': draws['u'].to(torch.float32).contiguous()}
    for name, x in dr.items():
        if tuple(x.shape) != shape or x.device != dev:
            raise ValueError(f"draws[{name!r}] must be {list(shape)} on "
                             f"{dev}, got {tuple(x.shape)} on {x.device}.")
    # A copy in every case: the launch updates pos_bp in place, and with
    # P == 1 or B == 1 ``pos.T.contiguous()`` would be a view of ``pos``.
    return dict(rows=rows, min_rows=min_rows,
                pos_bp=pos.T.clone(memory_format=torch.contiguous_format),
                min_lt=batch.min_log2_total.to(torch.float32).clone(),
                applied=torch.zeros(batch.c0.shape[1], dtype=torch.int32,
                                    device=dev),
                draws=dr, betas=betas.contiguous(),
                log2d=log2d_w32.reshape(-1).contiguous())


def _one_beta_per_iteration(betas) -> None:
    """K5 reads one beta per iteration (``pallas_walker.py:549``), so
    per-replica ``[K, B]`` betas (a tempering ladder) raise, on the CPU
    too, rather than run on one row."""
    ndim = betas.dim() if isinstance(betas, torch.Tensor) else np.ndim(betas)
    if ndim != 1:
        raise ValueError(
            "The walker takes one beta per iteration ([K]); per-replica "
            "betas [K, B] run on 'batched', 'walks' and 'multiwalk'.")


def float32_only(dtype) -> None:
    """K5 keeps one 32-bit lcc lane per row (``pallas_walker.py:455,
    476``), so a float64 state raises rather than run rounded."""
    if dtype != torch.float32:
        raise ValueError(
            f"The walker runs float32 costs only, got {dtype}; float64 "
            "state runs on 'batched', 'vmapped', 'multiwalk' and 'walks'.")


def dense_only(sparse_wb) -> None:
    """K5 has no sparse cost model; it refuses sparse indices as the JAX
    walker does (``pallas_walker.py:504,645``)."""
    if sparse_wb is not None:
        raise NotImplementedError('walker engine: dense cost model only')


def run_walker(batch, betas, log2d_w32, cfg, n_walks: int, pos,
               sparse_wb=None, log2_n_projs=None, *, draws=None,
               generator=None):
    """K iterations of ``n_walks``-walk SA per replica, one per beta.

    Same contract as :func:`~tnco_tpu_torch.kernels.sa_multiwalk.
    run_multiwalk` (dense cost model, ``on_block='advance'``,
    ``accept_rule='round'``), and the JAX ``_run_walker``'s: state, min
    state, ``pos``, ``moves``, ``applied``, then the final min check and
    the hyper refresh.

    Args:
        batch: :class:`~tnco_tpu_torch.kernels.sa_batched.SABatch`.
        betas: ``[K]`` inverse temperatures.
        log2d_w32: ``float32 [W, 32]`` padded log2 dims.
        cfg: :class:`~tnco_tpu_torch.kernels.sa_infinite.SweepConfig`.
        n_walks: walks per replica, 1 to 128.
        pos: ``int32 [P, B]`` walk positions (-1 = start a fresh walk).
        sparse_wb, log2_n_projs: must be None (dense cost model only;
            sparse indices raise ``NotImplementedError``).
        draws: optional ``leaf``, ``rand_bit``, ``u``, each ``[K, P, B]``.
        generator: ``torch.Generator`` on the batch's device, used when
            ``draws`` is None.

    Returns ``(batch, {'moves', 'applied', 'pos'})``.
    """
    del log2_n_projs
    dense_only(sparse_wb)
    _one_beta_per_iteration(betas)
    if batch.c0.device.type == 'cpu':
        return run_walker_plain(batch, betas, log2d_w32, cfg, n_walks, pos,
                                draws=draws, generator=generator)
    if batch.c0.device.type != 'cuda':
        raise ValueError(f"Unsupported device: {batch.c0.device}.")
    _check(batch, cfg, n_walks, pos, log2d_w32)
    n, b = batch.c0.shape
    w = batch.inds.shape[1]
    betas = smw.as_betas(betas, batch.c0.device)
    if draws is None:
        if generator is None:
            raise ValueError("Pass draws= or generator=.")
        with span('tnco.walker.draws'):
            draws = smw.draw_chunk(generator, cfg.n_leaves, betas.shape[0],
                                   n_walks, b, log2d_w32.dtype)
    with span('tnco.walker.pack'):
        ops = kernel_inputs(batch, betas, log2d_w32, pos, draws)
    with span('tnco.walker.k5'):
        launch_walker(ops['rows'], ops['min_rows'], ops['pos_bp'],
                      ops['min_lt'], ops['applied'], ops['draws'],
                      ops['betas'], ops['log2d'], cfg, n, w)
    count('launches.walker_im')
    with span('tnco.walker.unpack'):
        c0, c1, par, lcc, inds = unpack_rows(ops['rows'], w)
        mc0, mc1, mpar, _, minds = unpack_rows(ops['min_rows'], w)
    with span('tnco.walker.finish'):
        out = smw.finish_batch(c0, c1, par, inds, lcc, ops['min_lt'], mc0,
                               mc1, mpar, minds, batch.keys.clone(),
                               cfg.n_leaves)
    return out, {'moves': n_walks * b * betas.shape[0],
                 'applied': ops['applied'].sum(dtype=torch.int64),
                 'pos': ops['pos_bp'].T.contiguous()}


# ------------------------------ finite width ------------------------------


def row_words_fw(w: int) -> int:
    """Words per FW row: the 5-word header and ``W`` index words,
    rounded up to a multiple of 4."""
    return -(-(_HDR_FW + w) // 4) * 4


def pack_rows_fw(c0, c1, par, lcc, inds, width, slices):
    """FW tensors -> ``int32 [B, N + 1, R]`` rows: c0, c1, par, lcc
    bits, the pre-slicing width bits, the index words, zero padding; row
    ``N`` holds the slice lanes in the index words (children and parent
    NULL, lcc -inf, so it reads as an inert node)."""
    n, w, b = inds.shape
    rows = torch.zeros((b, n + 1, row_words_fw(w)), dtype=torch.int32,
                       device=c0.device)
    rows[:, :n, _C0] = c0.T
    rows[:, :n, _C1] = c1.T
    rows[:, :n, _PAR] = par.T
    rows[:, :n, _LCC] = lcc.T.view(torch.int32)
    rows[:, :n, _WPRE] = width.T.view(torch.int32)
    rows[:, :n, _HDR_FW:_HDR_FW + w] = inds.permute(2, 0, 1)
    rows[:, n, _C0:_PAR + 1] = smw.NULL
    rows[:, n, _LCC] = _NEG_INF_BITS
    rows[:, n, _HDR_FW:_HDR_FW + w] = slices.T
    return rows


def unpack_rows_fw(rows, w: int):
    """Inverse of :func:`pack_rows_fw`: ``c0, c1, par, lcc, inds, width,
    slices``."""
    n = rows.shape[1] - 1
    c0, c1, par = (rows[:, :n, f].T.contiguous() for f in (_C0, _C1, _PAR))
    lcc = rows[:, :n, _LCC].T.contiguous().view(torch.float32)
    width = rows[:, :n, _WPRE].T.contiguous().view(torch.float32)
    inds = rows[:, :n, _HDR_FW:_HDR_FW + w].permute(1, 2, 0).contiguous()
    slices = rows[:, n, _HDR_FW:_HDR_FW + w].T.contiguous()
    return c0, c1, par, lcc, inds, width, slices


def _integer_log2(uniform_log2):
    """The walker's widths and slicer route: the common log2 dim where it
    is an integer (popcount widths and the plane slicer, bitwise equal
    to the pinned tree and the reference slicer there), else None."""
    if uniform_log2 is None or not float(uniform_log2).is_integer():
        return None
    return uniform_log2


def run_walker_fw_plain(batch, betas, update_slices_mask, max_width,
                        log2d_w32, skip_wb, cfg, n_walks: int, pos, *,
                        uniform_log2=None, draws=None, generator=None):
    """Plain PyTorch version of :func:`run_walker_fw` (its yardstick on
    the card): the FW multi-walk engine."""
    _check(batch, cfg, n_walks, pos, log2d_w32, fw=True)
    return smw.run_multiwalk_fw(batch, betas, update_slices_mask, max_width,
                                log2d_w32, skip_wb, cfg, n_walks, pos,
                                uniform_log2=_integer_log2(uniform_log2),
                                draws=draws, generator=generator)


def launch_walker_fw(seg, draws, betas, log2d_w32, cfg, max_width: float,
                     defer_last_min: bool, lib=None):
    """One K5-FW launch on the packed buffers of ``seg`` (``rows``,
    ``min_rows``, ``pos_bp``, ``min_lt``, ``applied``), updated in place;
    ``draws`` are the segment's int32/float32 ``[K, P, B]`` streams (no
    counting: :func:`walker_fw_segment` counts, and timing code calls
    this directly).  ``lib`` as in :func:`launch_walker`."""
    rows = seg['rows']
    b, n1, r = rows.shape
    k, p = draws['leaf'].shape[:2]
    log2d = log2d_w32.reshape(-1).contiguous()
    lib = lib or build.load()
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    rc = lib.tnco_walker_fw(
        rows.data_ptr(), seg['min_rows'].data_ptr(), seg['pos_bp'].data_ptr(),
        seg['min_lt'].data_ptr(), seg['applied'].data_ptr(),
        draws['leaf'].data_ptr(), draws['rand_bit'].data_ptr(),
        draws['u'].data_ptr(), betas.data_ptr(), log2d.data_ptr(), b, n1 - 1,
        cfg.n_leaves, cfg.n_lanes, r, p, k, _pow2(n1 - 1 - cfg.n_leaves),
        _PROB_KIND[cfg.prob_kind], int(cfg.disable_shared_inds),
        float(max_width), int(defer_last_min), stream)
    build.check(rc, 'walker_fw')


def walker_fw_segment_plain(seg, draws, betas, log2d_w32, cfg, max_width,
                            defer_last_min: bool, uniform_log2=None):
    """Plain version of one K5-FW launch: the FW multi-walk iterations
    of ``betas`` without the reslice, each ending in the min snapshot
    except the last when ``defer_last_min``; ``seg``'s buffers are
    updated in place (the min rows' lcc and width words are kept: they
    are not part of the min state)."""
    rows, min_rows = seg['rows'], seg['min_rows']
    w = cfg.n_lanes
    n = rows.shape[1] - 1
    max_width = torch.as_tensor(max_width, dtype=torch.float32,
                                device=rows.device)
    c0, c1, par, lcc, inds, width, slices = unpack_rows_fw(rows, w)
    mc0, mc1, mpar, mlcc, minds, mwidth, mslices = unpack_rows_fw(min_rows,
                                                                  w)
    st = smw.padded_state(c0, c1, par, inds, lcc, width)
    st.update(slices=slices, min_c0=mc0, min_c1=mc1, min_par=mpar,
              min_inds=minds, min_slices=mslices, min_lt=seg['min_lt'],
              pos=seg['pos_bp'], moves=0,
              applied=torch.zeros((), dtype=torch.int64, device=rows.device))
    k = betas.shape[0]
    for t in range(k):
        dr = {'leaf': draws['leaf'][t].T, 'rand_bit': draws['rand_bit'][t].T
              != 0, 'u': draws['u'][t].T}
        keep = smw._iter_multiwalk_fw(st, betas[t], dr, max_width, log2d_w32,
                                      cfg, uniform_log2, n,
                                      smw.sparse_args(None, None))
        seg['applied'] += keep.sum(dim=1, dtype=torch.int32)
        if not (defer_last_min and t == k - 1):
            smw._snapshot(st, n, cfg.n_leaves)
    rows.copy_(pack_rows_fw(st['c0'][:n], st['c1'][:n], st['par'][:n],
                            st['lcc'][:n], st['inds'][:n], st['width'][:n],
                            st['slices']))
    min_rows.copy_(pack_rows_fw(st['min_c0'], st['min_c1'], st['min_par'],
                                mlcc, st['min_inds'], mwidth,
                                st['min_slices']))
    seg['pos_bp'].copy_(st['pos'])
    seg['min_lt'].copy_(st['min_lt'])


def walker_fw_segment(seg, draws, betas, log2d_w32, cfg, max_width: float,
                      defer_last_min: bool, uniform_log2=None):
    """One segment of :func:`run_walker_fw` (``pallas_walker.py:723-816``)
    on ``seg``'s packed buffers, in place: a K5-FW launch for CUDA
    buffers, :func:`walker_fw_segment_plain` for CPU buffers.
    ``max_width`` is a host float (a float32 value)."""
    if seg['rows'].device.type == 'cpu':
        walker_fw_segment_plain(seg, draws, betas, log2d_w32, cfg, max_width,
                                defer_last_min, uniform_log2)
        return
    launch_walker_fw(seg, draws, betas, log2d_w32, cfg, max_width,
                     defer_last_min)
    count('launches.walker_fw')


def walker_fw_reslice(seg, jitter, max_width, log2d_w32, skip_wb, cfg,
                      uniform_log2=None):
    """The reslice between segments (``pallas_walker.py:819-852``), on
    the packed rows in place: the greedy reslice-if-better reads the
    index words and pre-slicing widths from the rows and writes the lcc
    words and the slice row back; replicas whose exact total is then
    strictly below their min snapshot their whole rows, slice row
    included.  ``has_slices`` is global over the batch, as in the
    reference."""
    rows, min_rows, min_lt = seg['rows'], seg['min_rows'], seg['min_lt']
    w = cfg.n_lanes
    n = rows.shape[1] - 1
    lcc = rows[:, :n, _LCC].T.contiguous().view(torch.float32)
    slices = rows[:, n, _HDR_FW:_HDR_FW + w].T
    if host_read((slices != 0).any(), bool):
        width = rows[:, :n, _WPRE].T.contiguous().view(torch.float32)
        new_slices, lcc = smw.reslice_if_better(
            rows[:, :n, _C0].T, rows[:, :n, _C1].T,
            rows[:, :n, _HDR_FW:_HDR_FW + w].permute(1, 2, 0), width,
            slices, lcc, jitter, max_width, log2d_w32, skip_wb, cfg.n_leaves,
            uniform_log2)
        rows[:, :n, _LCC] = lcc.T.view(torch.int32)
        rows[:, n, _HDR_FW:_HDR_FW + w] = new_slices.T
    lt_new = _log2_total_b(lcc, cfg.n_leaves)
    improved = lt_new < min_lt
    min_lt.copy_(torch.where(improved, lt_new, min_lt))
    min_rows.copy_(torch.where(improved[:, None, None], rows, min_rows))


def segments(mask) -> list:
    """``[(start, end, reslice_at_end)]``: the chunk split after every
    true mask entry (``pallas_walker.py:681-687``)."""
    k = len(mask)
    bounds = [0] + [i + 1 for i in range(k) if mask[i]]
    if bounds[-1] != k:
        bounds.append(k)
    return [(s0, s1, bool(mask[s1 - 1]))
            for s0, s1 in zip(bounds[:-1], bounds[1:])]


def kernel_inputs_fw(batch, pos):
    """The packed buffers of one FW chunk, updated in place by the
    segments and reslices: ``rows``, ``min_rows`` ``[B, N + 1, R]``,
    ``pos_bp [B, P]`` (always a copy), ``min_lt`` and ``applied [B]``."""
    dev = batch.c0.device
    return dict(
        rows=pack_rows_fw(batch.c0, batch.c1, batch.par, batch.lcc,
                          batch.inds, batch.width, batch.slices),
        min_rows=pack_rows_fw(batch.min_c0, batch.min_c1, batch.min_par,
                              torch.zeros_like(batch.lcc), batch.min_inds,
                              torch.zeros_like(batch.width),
                              batch.min_slices),
        pos_bp=pos.T.clone(memory_format=torch.contiguous_format),
        min_lt=batch.min_log2_total.to(torch.float32).clone(),
        applied=torch.zeros(batch.c0.shape[1], dtype=torch.int32,
                            device=dev))


def run_walker_fw(batch, betas, update_slices_mask, max_width, log2d_w32,
                  skip_wb, cfg, n_walks: int, pos, sparse_wb=None,
                  log2_n_projs=None, *, uniform_log2=None, draws=None,
                  generator=None):
    """Finite-width walker: the contract of :func:`~tnco_tpu_torch.
    kernels.sa_multiwalk.run_multiwalk_fw` (dense cost model,
    ``on_block='advance'``, ``accept_rule='round'``) and of the JAX
    package's ``run_walker_fw``.

    Args:
        batch: :class:`~tnco_tpu_torch.kernels.sa_finite_batched.SABatchFW`.
        betas: ``[K]`` inverse temperatures.
        update_slices_mask: ``[K]`` host booleans: the chunk is split into
            kernel segments after each true entry, and each such
            iteration ends with the greedy reslice-if-better.
        max_width: the width cap.
        log2d_w32: ``float32 [W, 32]`` padded log2 dims.
        skip_wb: ``int32 [W]`` (or ``[W, 1]``) lanes never sliced.
        cfg: ``SweepConfigFW``.
        n_walks: walks per replica, 1 to 128.
        pos: ``int32 [P, B]`` walk positions (-1 = start a fresh walk).
        sparse_wb, log2_n_projs: must be None (dense cost model only).
        uniform_log2: the common log2 dim, or None.  Where it is an
            integer the reslice takes the plane slicer and popcount
            costs, which give the reference path's values bitwise.
        draws: optional ``leaf``, ``rand_bit``, ``u`` ``[K, P, B]`` and
            ``jitter [R, n_bits, B]``, one per true mask entry in order.
        generator: ``torch.Generator`` on the batch's device, used when
            ``draws`` is None.

    Returns ``(batch, {'moves', 'applied', 'pos'})``.
    """
    del log2_n_projs
    dense_only(sparse_wb)
    _one_beta_per_iteration(betas)
    _check(batch, cfg, n_walks, pos, log2d_w32, fw=True)
    dev = batch.c0.device
    b = batch.c0.shape[1]
    betas = smw.as_betas(betas, dev)
    mask = np.asarray(update_slices_mask, dtype=bool)
    if mask.shape != (betas.shape[0],):
        raise ValueError("update_slices_mask must match betas, got "
                         f"{mask.shape} for {betas.shape[0]} betas.")
    uniform_log2 = _integer_log2(uniform_log2)
    draws = smw.fw_draws(draws, generator, mask, cfg, n_walks, b,
                         log2d_w32.dtype, dev)
    dr = {'leaf': draws['leaf'].to(torch.int32).contiguous(),
          'rand_bit': draws['rand_bit'].to(torch.int32).contiguous(),
          'u': draws['u'].to(torch.float32).contiguous()}
    # The cap as a host float holding its float32 value: one read per
    # chunk, none per launch.
    max_width = float(torch.as_tensor(max_width, dtype=torch.float32))
    log2d_w32 = log2d_w32.contiguous()
    seg = kernel_inputs_fw(batch, pos)
    r = 0
    for s0, s1, reslice in segments(mask):
        walker_fw_segment(seg, {k: v[s0:s1] for k, v in dr.items()},
                          betas[s0:s1], log2d_w32, cfg, max_width, reslice,
                          uniform_log2)
        if reslice:
            walker_fw_reslice(seg, draws['jitter'][r], max_width, log2d_w32,
                              skip_wb, cfg, uniform_log2)
            r += 1
    c0, c1, par, lcc, inds, width, slices = unpack_rows_fw(seg['rows'],
                                                           cfg.n_lanes)
    mc0, mc1, mpar, _, minds, _, mslices = unpack_rows_fw(seg['min_rows'],
                                                          cfg.n_lanes)
    out = smw.finish_batch_fw(c0, c1, par, inds, lcc, width, slices,
                              seg['min_lt'], mc0, mc1, mpar, minds, mslices,
                              batch.keys.clone(), cfg.n_leaves)
    return out, {'moves': n_walks * b * betas.shape[0],
                 'applied': seg['applied'].sum(dtype=torch.int64),
                 'pos': seg['pos_bp'].T.contiguous()}

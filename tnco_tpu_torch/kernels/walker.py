"""K5: the multi-walk SA walker, infinite memory — the port of
``tnco_tpu/kernels/pallas_walker.py`` (``walker_supported``,
``run_walker`` / ``_run_walker``).

:func:`run_walker` runs a K-iteration chunk of ``P``-walk SA for every
replica in one launch of the hand-written kernel ``csrc/walker.cu`` (one
CTA per replica), then does the final min check and the hyper refresh
through K1.  Its results equal :func:`run_walker_plain`, the plain
PyTorch version (the multi-walk engine
:func:`~tnco_tpu_torch.kernels.sa_multiwalk.run_multiwalk`), bitwise on
the same draws, as the TPU walker's results equal ``run_multiwalk``'s.
The draws are drawn before the launch, ``[K, P, B]`` each, and both
versions consume the same tensors.

A CUDA batch launches the kernel or raises; a CPU batch takes the plain
version.  No fallback.
"""

import torch

from tnco_tpu_torch.kernels import build
from tnco_tpu_torch.kernels import sa_multiwalk as smw

__all__ = ['walker_supported', 'run_walker', 'run_walker_plain',
           'launches']

# Kernel launches since the last reset (the main path's proof of route).
launches = 0

MAX_WALKS = 128           # the TPU kernel's 128 walk lanes
_HDR = 4                  # row header: c0, c1, par, lcc bits
_C0, _C1, _PAR, _LCC = 0, 1, 2, 3
_PROB_KIND = {'mh': 0, 'greedy': 1, 'base': 2}


def walker_supported(n: int, n_leaves: int, w: int) -> bool:
    """Where the walker runs (``pallas_walker.py:59-60``): at most 124
    index words, at least one internal node, fewer than 30000 nodes (the
    lcc column of one replica lives in shared memory)."""
    return w + _HDR <= 128 and n - n_leaves > 0 and n < 30000


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


def _check(batch, cfg, n_walks, pos, log2d_w32):
    n, b = batch.c0.shape
    w = batch.inds.shape[1]
    if not walker_supported(n, cfg.n_leaves, w):
        raise ValueError(
            f"The walker does not run on N={n}, n_leaves={cfg.n_leaves}, "
            f"W={w} (walker_supported: W <= 124, an internal node, "
            "N < 30000).")
    if not 1 <= n_walks <= MAX_WALKS:
        raise ValueError(f"n_walks must be in [1, {MAX_WALKS}], got "
                         f"{n_walks}.")
    if tuple(pos.shape) != (n_walks, b) or pos.dtype != torch.int32:
        raise ValueError(f"pos must be int32 [{n_walks}, {b}], got "
                         f"{tuple(pos.shape)} {pos.dtype}.")
    if tuple(log2d_w32.shape) != (w, 32):
        raise ValueError(f"log2d_w32 must be [{w}, 32], got "
                         f"{tuple(log2d_w32.shape)}.")
    smw.check_options(cfg, log2d_w32.dtype)


def run_walker_plain(batch, betas, log2d_w32, cfg, n_walks: int, pos, *,
                     draws=None, generator=None):
    """Plain PyTorch version of :func:`run_walker` (the CPU route, and
    the kernel's yardstick on the card): the multi-walk engine."""
    _check(batch, cfg, n_walks, pos, log2d_w32)
    return smw.run_multiwalk(batch, betas, log2d_w32, cfg, n_walks, pos,
                             draws=draws, generator=generator)


def launch_walker(rows, min_rows, pos_bp, min_lt, applied, draws, betas,
                  log2d, cfg, n: int, w: int):
    """One K5 launch on packed buffers, updated in place (no counting:
    :func:`run_walker` counts, and timing code calls this directly)."""
    b, _, r = rows.shape
    k, p = draws['leaf'].shape[:2]
    lib = build.load()
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


def run_walker(batch, betas, log2d_w32, cfg, n_walks: int, pos, *,
               draws=None, generator=None):
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
        draws: optional ``leaf``, ``rand_bit``, ``u``, each ``[K, P, B]``.
        generator: ``torch.Generator`` on the batch's device, used when
            ``draws`` is None.

    Returns ``(batch, {'moves', 'applied', 'pos'})``.
    """
    global launches
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
        draws = smw.draw_chunk(generator, cfg.n_leaves, betas.shape[0],
                               n_walks, b, log2d_w32.dtype)
    ops = kernel_inputs(batch, betas, log2d_w32, pos, draws)
    launch_walker(ops['rows'], ops['min_rows'], ops['pos_bp'],
                  ops['min_lt'], ops['applied'], ops['draws'], ops['betas'],
                  ops['log2d'], cfg, n, w)
    launches += 1
    c0, c1, par, lcc, inds = unpack_rows(ops['rows'], w)
    mc0, mc1, mpar, _, minds = unpack_rows(ops['min_rows'], w)
    out = smw.finish_batch(c0, c1, par, inds, lcc, ops['min_lt'], mc0, mc1,
                           mpar, minds, batch.keys.clone(), cfg.n_leaves)
    return out, {'moves': n_walks * b * betas.shape[0],
                 'applied': ops['applied'].sum(dtype=torch.int64),
                 'pos': ops['pos_bp'].T.contiguous()}

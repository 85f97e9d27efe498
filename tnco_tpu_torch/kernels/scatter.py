"""K2, K3 and K4: id inversion and the in-place and out-of-place row
scatters — the port of ``tnco_tpu/kernels/pallas_scatter.py``
(``inv_ids``, ``scatter_rows_inplace``, ``scatter_rows_gbn``).

- :func:`inv_ids`: ``inv[b, n] = q`` with ``ids[b, q] == n``, else -1;
  out-of-range ids are ignored and the LAST ``q`` wins on duplicates
  (the TPU kernel's rule, ``inv_ids(..., interpret=True)``).
- :func:`scatter_rows_inplace`: ``vals[lo + g, b, ids[b, q]] =
  upd[g, b, q]`` over the plane range, IN PLACE on the caller's tensor
  (where JAX donated the buffer); -1 writes nothing, and duplicates keep
  the last-q-wins result.  On the card it is one launch: the kernel
  resolves the winners itself (it does not call :func:`inv_ids`).
- :func:`scatter_rows_gbn`: the same scatter OUT OF PLACE: a new
  ``[hi - lo, B, N]`` tensor; the caller's ``vals`` is never written
  (JAX reuses its buffer only when the caller donates it).

CUDA tensors go to the hand-written kernels (``csrc/scatter.cu``); CPU
tensors go to the plain PyTorch versions (spec: ``_inv_xla`` and
``_scatter_xla`` composed with the inversion, ``pallas_scatter.py:85-94,
167-171``).  No fallback:
a CUDA call launches the kernel or raises.
"""

import torch

from tnco_tpu_torch.kernels import build
from tnco_tpu_torch.kernels.gather import _check, _plane_range
from tnco_tpu_torch.utils.profiling import count

__all__ = ['inv_ids', 'scatter_rows_inplace', 'scatter_rows_gbn',
           'inv_ids_plain', 'scatter_rows_inplace_plain',
           'scatter_rows_gbn_plain', 'scatter_route', 'inv_slices']


# K3 keeps its [N] winner map and its winner list (2 min(Q, N) words) in
# shared memory up to this size (csrc/scatter.cu: kSmemBytes), else in a
# global scratch row per replica.
_SMEM_BYTES = 48 * 1024


def scatter_route(n: int, q: int) -> str:
    """K3's route for ``q`` ids into rows of ``n`` words: 'smem' (the
    winner map in shared memory) or 'global' (in a scratch tensor)."""
    return 'smem' if 4 * (n + 2 * min(q, n)) <= _SMEM_BYTES else 'global'


# K2's columns per block, passed to the kernel (csrc/scatter.cu): one
# block per (replica, slice), an INV_SLICE-word map in shared memory, for
# every n.
INV_SLICE = 2048


def inv_slices(n: int) -> int:
    """K2's blocks per replica for rows of ``n`` words."""
    return -(-n // INV_SLICE)


def _check_ids(ids):
    if ids.dim() != 2 or ids.dtype != torch.int32 or \
            not ids.is_contiguous():
        raise ValueError("ids must be a contiguous int32 [B, Q] tensor, "
                         f"got {tuple(ids.shape)} {ids.dtype}.")
    if ids.device.type not in ('cpu', 'cuda'):
        raise ValueError(f"Unsupported device: {ids.device}.")


def inv_ids_plain(ids_bq, n: int):
    """Plain PyTorch version: a deterministic ``amax`` scatter of q."""
    b, q = ids_bq.shape
    ok = (ids_bq >= 0) & (ids_bq < n)
    safe = torch.where(ok, ids_bq, n).long()
    qi = torch.arange(q, dtype=torch.int32, device=ids_bq.device)
    inv = torch.full((b, n + 1), -1, dtype=torch.int32, device=ids_bq.device)
    inv.scatter_reduce_(1, safe, qi.expand(b, q), reduce='amax')
    return inv[:, :n].contiguous()


def inv_ids(ids_bq, n: int):
    """``ids_bq [B, Q]`` -> ``[B, n]`` inverse map (-1 where no id)."""
    _check_ids(ids_bq)
    if ids_bq.device.type == 'cpu':
        return inv_ids_plain(ids_bq, n)
    inv = torch.empty((ids_bq.shape[0], n), dtype=torch.int32,
                      device=ids_bq.device)
    if inv.numel() == 0:
        return inv
    _launch_inv(ids_bq, inv, INV_SLICE)
    count('launches.inv_ids')
    return inv


def _launch_inv(ids, inv, slice_words):
    """One K2 launch with ``slice_words`` columns a block (no counting;
    the wrapper counts, and timing code calls this directly)."""
    (b, q), n = ids.shape, inv.shape[1]
    lib = build.load()
    stream = torch.cuda.current_stream(ids.device).cuda_stream
    rc = lib.tnco_inv_ids(ids.data_ptr(), inv.data_ptr(), b, n, q,
                          slice_words, stream)
    build.check(rc, 'inv_ids')


def _check_upd(vals, ids, upd, lo, hi):
    if upd.dtype != vals.dtype or upd.device != vals.device or \
            not upd.is_contiguous():
        raise ValueError("upd must be contiguous, of vals' dtype and "
                         "device.")
    want = (hi - lo, vals.shape[1], ids.shape[1])
    if tuple(upd.shape) != want:
        raise ValueError(f"upd shape {tuple(upd.shape)} != {want}.")


def scatter_rows_gbn_plain(vals_gbn, ids_bq, upd_gbq, planes=None):
    """Plain PyTorch version of :func:`scatter_rows_gbn` (a new tensor)."""
    lo, hi = _plane_range(planes, vals_gbn.shape[0])
    n, q = vals_gbn.shape[2], ids_bq.shape[1]
    region = vals_gbn.view(torch.int32)[lo:hi]
    if q == 0:
        return region.clone().view(vals_gbn.dtype)
    inv = inv_ids_plain(ids_bq, n)
    safe = inv.clamp(0, q - 1).long()
    got = torch.gather(upd_gbq.view(torch.int32), 2,
                       safe[None].expand(hi - lo, -1, -1))
    return torch.where((inv >= 0)[None], got, region).view(vals_gbn.dtype)


def scatter_rows_inplace_plain(vals_gbn, ids_bq, upd_gbq, planes=None):
    """Plain PyTorch version; writes ``vals_gbn`` in place and returns
    it."""
    lo, hi = _plane_range(planes, vals_gbn.shape[0])
    vals_gbn.view(torch.int32)[lo:hi] = scatter_rows_gbn_plain(
        vals_gbn, ids_bq, upd_gbq, (lo, hi)).view(torch.int32)
    return vals_gbn


def scatter_rows_inplace(vals_gbn, ids_bq, upd_gbq, *, planes=None):
    """Row scatter into a plane range of ``vals_gbn``, in place.

    ``vals_gbn[lo + g, b, ids_bq[b, q]] = upd_gbq[g, b, q]`` for the
    ``planes=(lo, hi)`` range (default: all planes); returns ``vals_gbn``
    itself.
    """
    _check(vals_gbn, ids_bq)
    lo, hi = _plane_range(planes, vals_gbn.shape[0])
    _check_upd(vals_gbn, ids_bq, upd_gbq, lo, hi)
    if vals_gbn.device.type == 'cpu':
        return scatter_rows_inplace_plain(vals_gbn, ids_bq, upd_gbq,
                                          (lo, hi))
    n, q = vals_gbn.shape[2], ids_bq.shape[1]
    if upd_gbq.numel() and n:
        _launch_scatter(vals_gbn, ids_bq, upd_gbq, lo, hi,
                        scatter_route(n, q))
        count('launches.scatter_rows_inplace')
    return vals_gbn


def _launch_scatter(vals, ids, upd, lo, hi, route):
    """One K3 launch by ``route`` (no counting; the wrapper above counts,
    and timing code calls this directly)."""
    _, b, n = vals.shape
    q = ids.shape[1]
    scratch = None
    if route == 'global':
        scratch = torch.empty((b, n + 2 * min(q, n)), dtype=torch.int32,
                              device=vals.device)
    lib = build.load()
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    rc = lib.tnco_scatter_rows(vals.data_ptr() + lo * b * n * 4,
                               ids.data_ptr(), upd.data_ptr(),
                               None if scratch is None else
                               scratch.data_ptr(), hi - lo, b, n, q, stream)
    build.check(rc, 'scatter_rows_inplace')


def scatter_rows_gbn(vals_gbn, ids_bq, upd_gbq, *, planes=None):
    """Row scatter into a plane range of ``vals_gbn``, out of place.

    ``out[g, b, n] = upd_gbq[g, b, inv[b, n]]`` where ``ids_bq[b, inv[b,
    n]] == n``, else ``vals_gbn[lo + g, b, n]``, for the ``planes=(lo,
    hi)`` range (default: all planes); returns a new ``[hi - lo, B, N]``
    tensor of ``vals_gbn``' dtype.  ``vals_gbn`` is never modified.  -1
    and out-of-range ids write nothing; duplicates keep the last q (the
    inversion, K2).
    """
    _check(vals_gbn, ids_bq)
    lo, hi = _plane_range(planes, vals_gbn.shape[0])
    _check_upd(vals_gbn, ids_bq, upd_gbq, lo, hi)
    if vals_gbn.device.type == 'cpu':
        return scatter_rows_gbn_plain(vals_gbn, ids_bq, upd_gbq, (lo, hi))
    inv = inv_ids(ids_bq, vals_gbn.shape[2])
    out = torch.empty((hi - lo,) + tuple(vals_gbn.shape[1:]),
                      dtype=vals_gbn.dtype, device=vals_gbn.device)
    if out.numel():
        _launch_scatter_gbn(vals_gbn, inv, upd_gbq, out, lo)
        count('launches.scatter_rows_gbn')
    return out


def _launch_scatter_gbn(vals, inv, upd, out, lo):
    """One K4 launch with a precomputed inversion into ``out`` (no
    counting; the wrapper above counts, and timing code calls this
    directly)."""
    g, b, n = out.shape
    lib = build.load()
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    rc = lib.tnco_scatter_gbn(vals.data_ptr() + lo * b * n * 4,
                              inv.data_ptr(), upd.data_ptr(), out.data_ptr(),
                              g, b, n, upd.shape[2], stream)
    build.check(rc, 'scatter_rows_gbn')

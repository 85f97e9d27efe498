"""K1: per-replica row gather — the port of
``tnco_tpu/kernels/pallas_gather.py`` (``gather_gbn``, ``gather_bn``).

``out[g, b, q] = vals[lo + g, b, ids[b, q]]`` for ``0 <= id < N``; ids
outside that range (NULL = -1 in particular) give 0.  Any 4-byte dtype:
bits move unchanged.  ``planes=(lo, hi)`` reads a plane range without
copying the other planes.

A CUDA tensor goes to the hand-written kernel (``csrc/gather.cu``) by
one of its routes, which :func:`gather_route` picks from the shape; a
CPU tensor goes to :func:`gather_plain`, the plain PyTorch version with
the spec of ``_gather_xla`` (``pallas_gather.py:65-72``).  No fallback:
a CUDA call launches the kernel or raises.
"""

import torch

from tnco_tpu_torch.kernels import build

__all__ = ['gather_gbn', 'gather_bn', 'gather_plain', 'gather_route',
           'launches']

# Kernel launches since the last reset (the main path's proof of route).
launches = 0

# The kernel's routes (``csrc/gather.cu``).
_ROUTES = {'sparse': 0, 'row': 1}
# The row route takes rows of at most ROW_MAX_N words read at Q >=
# ROW_MIN_Q ids; set from a sweep of both routes on the card (PERF.md:
# scripts/profile_torch_gather_scatter.py).
ROW_MAX_N = 2048
ROW_MIN_Q = 2048


def gather_route(n: int, q: int) -> str:
    """The kernel's route for rows of ``n`` words read at ``q`` ids:
    'row' (the rows staged in shared memory) for many reads of small
    rows, else 'sparse' (loads straight from global memory)."""
    return 'row' if n <= ROW_MAX_N and q >= ROW_MIN_Q else 'sparse'


def _plane_range(planes, g: int):
    lo, hi = (0, g) if planes is None else (int(planes[0]), int(planes[1]))
    if not 0 <= lo <= hi <= g:
        raise ValueError(f"planes={planes} outside [0, {g}].")
    return lo, hi


def _check(vals, ids):
    if vals.dim() != 3 or vals.element_size() != 4:
        raise ValueError("vals must be a [G, B, N] tensor of a 4-byte "
                         f"dtype, got {tuple(vals.shape)} {vals.dtype}.")
    if ids.dim() != 2 or ids.dtype != torch.int32:
        raise ValueError("ids must be an int32 [B, Q] tensor, got "
                         f"{tuple(ids.shape)} {ids.dtype}.")
    if ids.shape[0] != vals.shape[1]:
        raise ValueError(f"ids rows {ids.shape[0]} != vals replicas "
                         f"{vals.shape[1]}.")
    if ids.device != vals.device:
        raise ValueError(f"vals on {vals.device}, ids on {ids.device}.")
    if not (vals.is_contiguous() and ids.is_contiguous()):
        raise ValueError("vals and ids must be contiguous.")
    if vals.device.type not in ('cpu', 'cuda'):
        raise ValueError(f"Unsupported device: {vals.device}.")


def gather_plain(vals_gbn, ids_bq, planes=None):
    """Plain PyTorch version (CPU tests, and the kernel's yardstick)."""
    lo, hi = _plane_range(planes, vals_gbn.shape[0])
    n = vals_gbn.shape[2]
    v = vals_gbn[lo:hi].view(torch.int32)
    g, (b, q) = hi - lo, ids_bq.shape
    if n == 0:
        return torch.zeros((g, b, q), dtype=vals_gbn.dtype,
                           device=vals_gbn.device)
    safe = ids_bq.clamp(0, n - 1).long()
    out = torch.gather(v, 2, safe[None].expand(g, b, q))
    ok = (ids_bq >= 0) & (ids_bq < n)
    out = torch.where(ok[None], out, torch.zeros((), dtype=torch.int32,
                                                 device=vals_gbn.device))
    return out.view(vals_gbn.dtype)


def gather_gbn(vals_gbn, ids_bq, *, planes=None):
    """``vals_gbn [G, B, N]`` planes x ``ids_bq [B, Q]`` -> ``[hi - lo,
    B, Q]``."""
    global launches
    _check(vals_gbn, ids_bq)
    lo, hi = _plane_range(planes, vals_gbn.shape[0])
    if vals_gbn.device.type == 'cpu':
        return gather_plain(vals_gbn, ids_bq, (lo, hi))
    _, b, n = vals_gbn.shape
    q = ids_bq.shape[1]
    out = torch.empty((hi - lo, b, q), dtype=vals_gbn.dtype,
                      device=vals_gbn.device)
    if out.numel() == 0:
        return out
    _launch(vals_gbn, ids_bq, out, lo, gather_route(n, q))
    launches += 1
    return out


def _launch(vals, ids, out, lo, route):
    """One K1 launch by ``route`` into ``out`` (no counting; the wrapper
    above counts, and timing code calls this directly)."""
    _, b, n = vals.shape
    g, _, q = out.shape
    lib = build.load()
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    rc = lib.tnco_gather_gbn(vals.data_ptr() + lo * b * n * 4,
                             ids.data_ptr(), out.data_ptr(), g, b, n, q,
                             _ROUTES[route], stream)
    build.check(rc, 'gather_gbn')


def gather_bn(vals_bn, ids_bq):
    """``vals_bn [B, N]`` x ``ids_bq [B, Q]`` -> ``[B, Q]`` (single-plane
    wrapper)."""
    return gather_gbn(vals_bn[None], ids_bq)[0]

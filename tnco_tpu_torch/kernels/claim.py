"""The walk engines' sequential (priority) claim: walk ``i`` of a replica
is kept iff it was accepted and none of its five nodes {A, B, C, D, E}
meets a node of a KEPT walk of lower index (the scan of
``tnco_tpu/kernels/sa_multiwalk.py:282-302``).

A CUDA tensor goes to the hand-written kernel (``csrc/claim.cu``), one
launch a call; a CPU tensor goes to :func:`claim_disjoint_plain`.  No
fallback: a CUDA call launches the kernel or raises.  Ids compare as
values, NULL (-1) included.
"""

import ctypes

import torch

from tnco_tpu_torch.kernels import build
from tnco_tpu_torch.utils.profiling import count

__all__ = ['claim_disjoint', 'claim_disjoint_plain', 'conflicts', 'MAX_P']

_NODES = ('a', 'b', 'c', 'd', 'e')
# The kernel keeps a replica's kept ids (5P int32) in one block's shared
# memory, at most 232448 bytes on an H100 (csrc/claim.cu: kMaxSmem).
MAX_P = 232448 // 20


def _check(accept, ev):
    if accept.dim() != 2 or accept.dtype != torch.bool:
        raise ValueError("accept must be a bool [B, P] tensor, got "
                         f"{tuple(accept.shape)} {accept.dtype}.")
    for k in _NODES:
        x = ev[k]
        if x.dtype != torch.int32 or x.shape != accept.shape:
            raise ValueError(
                f"ids {k!r} must be an int32 {tuple(accept.shape)} tensor "
                f"like accept, got {tuple(x.shape)} {x.dtype}.")
        if x.device != accept.device:
            raise ValueError(f"accept on {accept.device}, ids {k!r} on "
                             f"{x.device}.")
    if accept.device.type not in ('cpu', 'cuda'):
        raise ValueError(f"Unsupported device: {accept.device}.")


def conflicts(ev):
    """The symmetric conflict matrix ``M[b, p, q]``: walks ``p`` and
    ``q`` share a node of {A, B, C, D, E}."""
    nodes5 = [ev[k] for k in ('a', 'b', 'c', 'd', 'e')]
    b, p = nodes5[0].shape
    confl = torch.zeros((b, p, p), dtype=torch.bool,
                        device=nodes5[0].device)
    for x in nodes5:
        for y in nodes5:
            confl |= x[:, :, None] == y[:, None, :]
    return confl


def claim_disjoint_plain(accept, ev):
    """Plain PyTorch version (CPU tests, and the kernel's yardstick).

    The symmetric conflict matrix is built once; the scan then runs walk
    by walk, the same boolean decisions as the JAX scan.
    """
    confl = conflicts(ev)
    keep = torch.zeros_like(accept)
    for i in range(accept.shape[1]):
        blocked = (keep & confl[:, i, :]).any(dim=1)
        keep[:, i] = accept[:, i] & ~blocked
    return keep


def claim_disjoint(accept, ev):
    """``accept`` (bool ``[B, P]``) and the int32 ``[B, P]`` ids
    ``ev['a']`` ... ``ev['e']`` -> ``keep`` (bool ``[B, P]``).  Any
    strides: the kernel reads the planes where they lie."""
    _check(accept, ev)
    if accept.device.type == 'cpu':
        return claim_disjoint_plain(accept, ev)
    b, p = accept.shape
    if p > MAX_P:
        raise ValueError(f"the claim kernel takes at most {MAX_P} walks a "
                         f"replica, got {p}.")
    keep = torch.empty((b, p), dtype=torch.bool, device=accept.device)
    if keep.numel() == 0:
        return keep
    _launch(accept, [ev[k] for k in _NODES], keep)
    count('launches.claim_disjoint')
    return keep


def _launch(accept, ids, keep):
    """One launch into ``keep`` (no counting; the wrapper above counts,
    and timing code calls this directly)."""
    b, p = keep.shape
    lib = build.load()
    stream = torch.cuda.current_stream(keep.device).cuda_stream
    ptrs = (ctypes.c_void_p * 5)(*(x.data_ptr() for x in ids))
    sb = (ctypes.c_longlong * 5)(*(x.stride(0) for x in ids))
    sp = (ctypes.c_longlong * 5)(*(x.stride(1) for x in ids))
    rc = lib.tnco_claim_disjoint(ptrs, sb, sp, accept.data_ptr(),
                                 accept.stride(0), accept.stride(1),
                                 keep.data_ptr(), b, p, stream)
    build.check(rc, 'claim_disjoint')

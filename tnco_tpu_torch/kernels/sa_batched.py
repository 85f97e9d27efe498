"""Infinite-memory batch state, its host initializer, widths and totals
(from ``tnco_tpu/kernels/sa_batched.py``: ``SABatch`` :31-69,
``init_batch`` :71-177, ``_width_b`` :208-250, ``_log2_total_b``
:253-256, ``compute_hyper_b`` :259-267).

Layout is the reference's replica-minor one (replica axis LAST; ``keys``
replica-first), with ``uint32`` words held as ``int32`` bit patterns.
"""

from dataclasses import dataclass, fields

import numpy as np
import torch

from tnco_tpu_torch.kernels.gather import gather_gbn
from tnco_tpu_torch.kernels.sa_fullsweep import _width_bn
from tnco_tpu_torch.ops import costs as costs_ops

__all__ = ['SABatch', 'init_batch', 'compute_hyper_b']

_SPARSE = ('Sparse indices are not ported yet (ROADMAP queue 1, left out '
           'of slice 1, e).')


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
               log2_n_projs=None, dtype=np.float32, device='cpu') -> SABatch:
    """Builds a replica-minor batch on the host (numpy) and uploads it
    once to ``device``.

    Same arithmetic as the JAX package's ``init_batch`` (float64 word by
    word, then cast), so every field equals it bitwise.  The reference
    computes the caches once per unique tree and broadcasts them; this
    computes them per replica, with the same result.  Sparse indices are
    not ported yet.
    """
    if sparse_lanes is not None or log2_n_projs is not None:
        raise NotImplementedError(_SPARSE)
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

    # log2 cost per node: width of the union of the children, word by
    # word (one [N, W, 32, B] float64 expansion would be GBs at scale).
    union = inds_c0 | inds_c1
    shifts = np.arange(32, dtype=np.uint32)
    log2d_w32 = log2d.reshape(w, 32)
    lcc = np.zeros((n, b), dtype=np.float64)
    for word in range(w):
        bits = ((union[:, word, None, :] >>
                 shifts[None, :, None]) & 1).astype(np.float64)
        lcc += np.einsum('nsb,s->nb', bits, log2d_w32[word])
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
        return torch.from_numpy(x).to(device)

    return SABatch(up(c0), up(c1), up(par), up(inds), up(hyper), up(lcc),
                   up(lt), up(lt), up(c0), up(c1), up(par), up(inds),
                   up(keys))


def _width_b(lanes_wb, log2d_w32, *, sparse_wb=None, log2_n_projs=None,
             uniform_log2=None):
    """Width of ``int32 [W, ...]`` lane sets -> ``[...]``.

    Uniform dims with an integer log2 take the popcount (bitwise equal to
    the pinned tree: integer-valued float sums are exact); every other
    case takes the (w*32+s)-ordered pairwise-halving tree.
    """
    if sparse_wb is not None or log2_n_projs is not None:
        raise NotImplementedError(_SPARSE)
    if uniform_log2 is not None and not float(uniform_log2).is_integer():
        uniform_log2 = None
    return _width_bn(lanes_wb, log2d_w32, uniform_log2, log2d_w32.dtype)


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

"""Plane codecs and widths shared by the walks engine (from
``tnco_tpu/kernels/sa_fullsweep.py:88-205``).

The engine state is ``int32 [F, B, N_pad]`` planes of bit patterns:
index words, child/parent ids, and float costs bitcast into ``nk``
planes (one for float32, two for float64, low word first, as the JAX
package's ``bitcast_convert_type`` gives them).  Ids and words already
are int32, so the JAX package's ``_u32``/``_i32`` bitcasts have no
counterpart here.  The full-sweep engine itself is not ported yet.
"""

import numpy as np
import torch

from tnco_tpu_torch.ops.bitops import popcount32

__all__ = ['uniform_log2_dim']


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
    return planes.movedim(0, -1).contiguous().view(dtype)[..., 0]


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

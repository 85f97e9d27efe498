"""Array-level tensor utilities (numpy; the port's copy of
``tnco_tpu/utils/tensor.py``).

Backend dispatch is numpy by default and torch on request; there is no
jax branch.  Diagonal detection, recursive hyper-index decomposition,
einsum subscripts, pairwise ``tensordot`` with hyper (batched-diagonal)
semantics and truncated SVD follow the reference toolbox
(tnco/utils/tensor.py:34-360).
"""

from collections.abc import Iterable
import functools as fts
import itertools as its
import operator as op
from random import Random
from string import ascii_letters
from typing import Any

import numpy as np

from tnco_tpu_torch.ordered_frozenset import OrderedFrozenSet

__all__ = ['decompose_hyper_inds', 'get_einsum_subscripts', 'tensordot',
           'svd', 'is_diagonal', 'asarray']


def asarray(array, like=None, dtype=None):
    """Backend dispatch: numpy by default, torch when requested."""
    if like in (None, 'numpy'):
        if type(array).__module__.startswith('torch'):
            array = array.detach().cpu().numpy()
        return np.asarray(array, dtype=dtype)
    if like == 'torch':
        import torch
        return torch.as_tensor(np.asarray(array, dtype=dtype))
    raise ValueError(f"Unknown backend: {like!r}")


def is_diagonal(array, /, *, atol: float = 1e-8) -> bool:
    """Checks if the first two axes of ``array`` are diagonal.

    Reference: tnco/utils/tensor.py:34-65.
    """
    array = np.asarray(array)
    if array.ndim <= 1:
        raise ValueError("The array must have at least two dimensions.")
    if array.shape[0] != array.shape[1]:
        return False
    n = array.shape[0]
    mask = np.eye(n).reshape((n, n) + (1,) * (array.ndim - 2))
    return np.allclose(array * (1 - mask), 0, atol=atol)


def decompose_hyper_inds(array,
                         inds: Iterable,
                         *,
                         atol: float = 1e-8,
                         **kwargs):
    """Recursively decomposes diagonal axis pairs into hyper-indices.

    Reference: tnco/utils/tensor.py:68-143.  Returns
    ``((new_array, new_inds), hyper_inds)`` where ``hyper_inds`` maps a
    kept index to the frozenset of indices merged into it.
    """
    _hyper_inds = kwargs.pop('_hyper_inds', None)
    if kwargs:
        raise TypeError("Got unexpected keyword arguments.")

    array = np.asarray(array)
    inds = tuple(inds)
    if array.ndim != len(inds):
        raise ValueError("Wrong number of indices.")
    if len(set(inds)) != len(inds):
        raise ValueError("'inds' has duplicated indices.")

    if _hyper_inds is None:
        _hyper_inds = {}

    def pad(xs):
        return tuple(xs) + tuple(x for x in range(array.ndim) if x not in xs)

    h_inds = next(
        ((i, j)
         for i in range(array.ndim)
         for j in range(i + 1, array.ndim)
         if is_diagonal(array.transpose(pad((i, j))), atol=atol)), None)
    if h_inds is None:
        return (array, inds), _hyper_inds

    inds = tuple(inds[x] for x in pad(h_inds))
    array = array.transpose(pad(h_inds))

    # Merge index 0 into index 1 and keep the diagonal
    _hyper_inds[inds[1]] = (_hyper_inds.get(inds[0], frozenset())
                            | _hyper_inds.get(inds[1], frozenset())
                            | {inds[0]})
    _hyper_inds.pop(inds[0], None)
    inds = inds[1:]
    array = np.stack([array[x, x] for x in range(array.shape[0])])

    # Fully uniform diagonal (e.g. permutations): collapse to a scalar
    if array.size and np.allclose(array, array.ravel()[0], atol=atol):
        return (array.ravel()[0] * np.ones(()), ()), _hyper_inds

    return decompose_hyper_inds(array, inds, atol=atol,
                                _hyper_inds=_hyper_inds)


def get_einsum_subscripts(inds_a, inds_b, output_inds, /) -> str:
    """Einsum subscripts for ``inds_a, inds_b -> output_inds``.

    Reference: tnco/utils/tensor.py:146-173.

    Examples:
        >>> from tnco_tpu_torch.utils.tensor import get_einsum_subscripts
        >>> get_einsum_subscripts(['i', 'j'], ['j', 'k'], ['i', 'k'])
        'ab,bc->ac'
    """
    uniq = dict.fromkeys(its.chain(inds_a, inds_b, output_inds))
    cntr = dict(zip(uniq, ascii_letters))
    return (''.join(cntr[x] for x in inds_a) + ',' +
            ''.join(cntr[x] for x in inds_b) + '->' +
            ''.join(cntr[x] for x in output_inds))


def tensordot(x, y, /, *, hyper_inds=None, return_inds_only: bool = False):
    """Contracts two labeled tensors with hyper-index semantics.

    Hyper indices behave as batched diagonals: they survive the contraction
    and batch both operands (reference: tnco/utils/tensor.py:176-257).
    """
    xs, ys = map(OrderedFrozenSet, (x[1], y[1]))

    if hyper_inds is None:
        hyper_inds = ()
    hyper_inds = OrderedFrozenSet(hyper_inds)
    if not frozenset(xs & ys).issuperset(hyper_inds):
        raise ValueError("'hyper_inds' must be a list of shared indices.")

    shared_inds = xs & ys
    shared_no_hyper = shared_inds - hyper_inds
    xs_not_shared = xs - shared_inds
    ys_not_shared = ys - shared_inds

    zs = hyper_inds | xs_not_shared | ys_not_shared
    if return_inds_only:
        return tuple(zs)

    ax = np.asarray(x[0])
    ay = np.asarray(y[0])
    dims = dict(its.chain(zip(xs, ax.shape), zip(ys, ay.shape)))

    new_xs = tuple(hyper_inds | xs_not_shared | shared_no_hyper)
    new_ys = tuple(hyper_inds | shared_no_hyper | ys_not_shared)

    xs_t, ys_t = tuple(xs), tuple(ys)

    def size(labels):
        return fts.reduce(op.mul, (dims[i] for i in labels), 1)

    ax = ax.transpose([xs_t.index(i) for i in new_xs]).reshape(
        (size(hyper_inds), size(xs_not_shared), size(shared_no_hyper)))
    ay = ay.transpose([ys_t.index(i) for i in new_ys]).reshape(
        (size(hyper_inds), size(shared_no_hyper), size(ys_not_shared)))

    az = (ax @ ay).reshape(tuple(dims[i] for i in zs))
    return az, tuple(zs)


def svd(array,
        inds: Iterable,
        left_inds: Iterable,
        *,
        svd_index_name: Any | None = None,
        atol: float = 1e-8,
        seed: int | None = None):
    """Truncated SVD of a labeled tensor: returns [(U, .), (s, .), (Vh, .)].

    Reference: tnco/utils/tensor.py:260-360.
    """
    array = np.asarray(array)
    inds = tuple(inds)
    left_inds = tuple(left_inds)

    if array.ndim != len(inds):
        raise ValueError("Wrong number of indices.")
    if not frozenset(left_inds).issubset(inds):
        raise ValueError("'left_inds' must be a subset of 'inds'.")
    if svd_index_name in inds:
        raise ValueError("'svd_index_name' must be different from 'inds'.")

    if svd_index_name is None:
        rng = Random(seed)
        while (svd_index_name := ''.join(rng.choices(ascii_letters,
                                                     k=10))) in inds:
            pass

    if len(left_inds) in (0, array.ndim):
        left_inds = inds if len(left_inds) == 0 else left_inds
        return [(array.transpose(tuple(inds.index(x) for x in left_inds)),
                 left_inds)]

    dims = dict(zip(inds, array.shape))
    right_inds = tuple(x for x in inds if x not in left_inds)
    left_size = fts.reduce(op.mul, (dims[x] for x in left_inds), 1)

    array = array.transpose(tuple(
        inds.index(x) for x in left_inds + right_inds)).reshape(
            (left_size, -1))

    u, s, vh = np.linalg.svd(array, full_matrices=False)
    pos = s >= atol
    u, s, vh = u[:, pos], s[pos], vh[pos]

    u = u.reshape(tuple(dims[x] for x in left_inds) + (-1,))
    vh = vh.reshape((-1,) + tuple(dims[x] for x in right_inds))
    return ((u, (*left_inds, svd_index_name)), (s, (svd_index_name,)),
            (vh, (svd_index_name, *right_inds)))

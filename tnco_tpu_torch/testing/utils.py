"""Comparison helpers (the port's copy of what it needs from
``tnco_tpu/testing/utils.py``: ``assert_batches_identical``, :231-254),
and the mixed log2-dims table of the walker's card timings."""

import numpy as np
import torch

__all__ = ['assert_tensors_identical', 'assert_batches_identical',
           'mixed_log2d_table']

_TOTALS = ('log2_total', 'min_log2_total')


def _bits(x):
    a = x.detach().cpu().numpy()
    return a.view(f'<u{a.dtype.itemsize}') if a.dtype.kind == 'f' else a


def assert_tensors_identical(ref, got, what=''):
    """Same dtype, shape and bits (floats compared as their words, so NaN
    payloads and the sign of zero count)."""
    if ref.dtype != got.dtype:
        raise AssertionError(f'{what}: dtype {got.dtype} != {ref.dtype}')
    np.testing.assert_array_equal(_bits(got), _bits(ref), err_msg=what)


def assert_batches_identical(ref, got, *, total_rtol=3e-7):
    """Cross-engine batch equality: exact state, ulp-tolerant totals.

    Every field of two batches of one class (``SABatch`` or
    ``SABatchFW``) is compared bitwise, except the derived totals
    ``log2_total`` and ``min_log2_total``, which pass through
    ``exp2``/``log2`` and are compared to ``total_rtol`` (about 2 ulp),
    as the JAX package's helper does.
    """
    if type(ref) is not type(got):
        raise AssertionError(f'{type(got).__name__} != {type(ref).__name__}')
    for name in type(ref).field_names():
        a, b = getattr(ref, name), getattr(got, name)
        if name in _TOTALS:
            np.testing.assert_allclose(b.cpu().numpy(), a.cpu().numpy(),
                                       rtol=total_rtol, atol=0, err_msg=name)
        else:
            assert_tensors_identical(a, b, name)


def mixed_log2d_table(log2d_w32, seed=0):
    """A ``[W, 32]`` log2-dims table of the same shape as ``log2d_w32``
    with mixed dims (log2 of 2 to 5, drawn from ``seed``) where it has an
    index and 0 elsewhere: the walker kernel's tree width route on a
    state whose own dims take its popcount route."""
    rng = np.random.default_rng(seed)
    d = rng.integers(2, 6, log2d_w32.numel()).astype(np.float32)
    mixed = torch.from_numpy(np.log2(d)).to(log2d_w32.device)
    return torch.where(log2d_w32.reshape(-1) != 0, mixed,
                       0.0).reshape(log2d_w32.shape).contiguous()

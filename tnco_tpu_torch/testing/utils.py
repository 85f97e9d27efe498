"""Comparison helpers (the port's copy of what it needs from
``tnco_tpu/testing/utils.py``: ``assert_batches_identical``, :231-254)."""

import numpy as np

__all__ = ['assert_tensors_identical', 'assert_batches_identical']

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

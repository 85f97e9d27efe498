"""Carries a finite-width batch across from the JAX package's layout.

The state of this system plays the role of a model's weights: tests start
the JAX engine and the port from one state.  :func:`batch_fw_from_numpy`
takes the JAX ``SABatchFW`` fields as numpy arrays (``uint32`` words
become ``int32`` bit patterns) and builds the port's batch on a device;
:func:`batch_fw_to_numpy` goes back (``int32`` words of the bitset and
key fields return as ``uint32``).
"""

import numpy as np
import torch

from tnco_tpu_torch.kernels.sa_finite_batched import SABatchFW

__all__ = ['batch_fw_from_numpy', 'batch_fw_to_numpy']

# Fields that hold uint32 words in the JAX package.
_UINT32_FIELDS = ('inds', 'hyper', 'slices', 'min_inds', 'min_slices',
                  'keys')


def batch_fw_from_numpy(fields: dict, device) -> SABatchFW:
    """``{name: np.ndarray}`` (JAX layout) -> :class:`SABatchFW`."""
    out = {}
    for name in SABatchFW.field_names():
        x = np.ascontiguousarray(fields[name])
        if x.dtype == np.uint32:
            x = x.view(np.int32)
        out[name] = torch.from_numpy(x.copy()).to(device)
    return SABatchFW(**out)


def batch_fw_to_numpy(batch: SABatchFW) -> dict:
    """:class:`SABatchFW` -> ``{name: np.ndarray}`` in the JAX layout."""
    out = {}
    for name in SABatchFW.field_names():
        x = getattr(batch, name).detach().cpu().numpy()
        if name in _UINT32_FIELDS:
            x = x.view(np.uint32)
        out[name] = x
    return out

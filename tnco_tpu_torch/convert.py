"""Carries a batch across from the JAX package's layout.

The state of this system plays the role of a model's weights: tests start
the JAX engine and the port from one state.  :func:`batch_from_numpy`
(infinite memory, ``SABatch``) and :func:`batch_fw_from_numpy` (finite
width, ``SABatchFW``) take the JAX batch's fields as numpy arrays
(``uint32`` words become ``int32`` bit patterns) and build the port's
batch on a device; :func:`batch_to_numpy` and :func:`batch_fw_to_numpy`
go back (``int32`` words of the bitset and key fields return as
``uint32``).  :func:`state_from_numpy` and :func:`state_fw_from_numpy`
build the single-replica ``SAStateIM`` / ``SAStateFW`` of a JAX
optimizer's ``_state`` the same way, so both optimizers start from one
state.  :func:`sampling_state_from_numpy` does the same for the
sampler's intermediate state, so that both sampling loops run on the
same optimized paths.  (A JAX checkpoint ``.npz`` of a 'batched' runner
loads with :func:`tnco_tpu_torch.parallel.checkpoint.load_batch`.)
"""

from decimal import Decimal

import numpy as np
import torch

from tnco_tpu_torch.kernels.sa_batched import SABatch
from tnco_tpu_torch.kernels.sa_finite import SAStateFW
from tnco_tpu_torch.kernels.sa_finite_batched import SABatchFW
from tnco_tpu_torch.kernels.sa_infinite import SAStateIM

__all__ = ['batch_from_numpy', 'batch_to_numpy', 'batch_fw_from_numpy',
           'batch_fw_to_numpy', 'state_from_numpy', 'state_fw_from_numpy',
           'sampling_state_from_numpy']

# Fields that hold uint32 words in the JAX package.
_UINT32_FIELDS = ('inds', 'hyper', 'slices', 'min_inds', 'min_slices',
                  'keys', 'key')


def _from_numpy(cls, fields: dict, device):
    out = {}
    for name in cls.field_names():
        x = np.ascontiguousarray(fields[name])
        if x.dtype == np.uint32:
            x = x.view(np.int32)
        out[name] = torch.from_numpy(x.copy()).to(device)
    return cls(**out)


def _to_numpy(batch) -> dict:
    out = {}
    for name in type(batch).field_names():
        x = getattr(batch, name).detach().cpu().numpy()
        if name in _UINT32_FIELDS:
            x = x.view(np.uint32)
        out[name] = x
    return out


def batch_from_numpy(fields: dict, device) -> SABatch:
    """``{name: np.ndarray}`` (JAX ``SABatch`` layout) -> :class:`SABatch`."""
    return _from_numpy(SABatch, fields, device)


def batch_to_numpy(batch: SABatch) -> dict:
    """:class:`SABatch` -> ``{name: np.ndarray}`` in the JAX layout."""
    return _to_numpy(batch)


def batch_fw_from_numpy(fields: dict, device) -> SABatchFW:
    """``{name: np.ndarray}`` (JAX layout) -> :class:`SABatchFW`."""
    return _from_numpy(SABatchFW, fields, device)


def batch_fw_to_numpy(batch: SABatchFW) -> dict:
    """:class:`SABatchFW` -> ``{name: np.ndarray}`` in the JAX layout."""
    return _to_numpy(batch)


def state_from_numpy(fields: dict, device) -> SAStateIM:
    """``{name: np.ndarray}`` (a JAX ``SAStateIM``'s fields) ->
    :class:`~tnco_tpu_torch.kernels.sa_infinite.SAStateIM`."""
    return _from_numpy(SAStateIM, fields, device)


def state_fw_from_numpy(fields: dict, device) -> SAStateFW:
    """``{name: np.ndarray}`` (a JAX ``SAStateFW``'s fields) ->
    :class:`~tnco_tpu_torch.kernels.sa_finite.SAStateFW`."""
    return _from_numpy(SAStateFW, fields, device)


def sampling_state_from_numpy(data, qubits):
    """Plain tuples of a JAX ``SamplingIntermediateState`` -> the port's.

    ``data`` holds one entry per circuit operation: ``(None, perm,
    op_qubits)`` for a classical operation (its 0/1 permutation matrix),
    else ``(ts_inds, arrays, cost, path, slices, output_qubits,
    op_qubits)``: the prefix network's tensor indices (projectors last),
    its numpy arrays (without the projectors), the best result's exact
    cost, path and sliced indices (None for an infinite-memory result).
    The results carry no per-component fields, which the sampling loop
    does not read.
    """
    from tnco_tpu_torch.app.circuit import SamplingIntermediateState
    from tnco_tpu_torch.app.finite_width.sa import \
        ContractionResults as FWResults
    from tnco_tpu_torch.app.infinite_memory.sa import \
        ContractionResults as IMResults
    from tnco_tpu_torch.app.tn import Tensor, TensorNetwork

    entries = []
    for entry in data:
        if entry[0] is None:
            _, perm, op_qubits = entry
            entries.append((None, None, np.asarray(perm), None,
                            tuple(op_qubits)))
            continue
        ts_inds, arrays, cost, path, slices, output_qubits, op_qubits = entry
        tn = TensorNetwork([Tensor(xs, dims=2) for xs in ts_inds],
                           output_inds=())
        common = dict(cost=Decimal(cost), runtime_s=0.0,
                      path=[tuple(p) for p in path], disconnected_costs=[],
                      disconnected_paths=[])
        result = (IMResults(**common) if slices is None else
                  FWResults(**common, disconnected_slices=[],
                            slices=frozenset(slices)))
        entries.append((tn, result, [np.asarray(a) for a in arrays],
                        tuple(output_qubits), tuple(op_qubits)))
    return SamplingIntermediateState(entries, qubits)

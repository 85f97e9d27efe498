"""Bitset-lane primitives on torch tensors.

Index sets are ``int32[..., W]`` lane words holding the bit patterns of
the reference's ``uint32`` lanes (bit ``j`` of word ``i`` = index
``32*i + j``).  torch has no popcount and no CPU ``>>`` on uint32, and
``>>`` on int32 sign-extends, so words stay int32 and every shift is
followed by a mask.
"""

import contextlib

import numpy as np
import torch

__all__ = ['pad_log2_dims', 'device_dtype', 'pairwise_sum_last',
           'popcount32', 'expand_bits', 'width', 'any_bits', 'popcount',
           'as_lanes', 'LANE_BITS',
           'enable_float64', 'set_float64', 'float64_enabled']

LANE_BITS = 32

# The port's float64 mode, the counterpart of JAX's x64 flag: off by
# default, so every engine runs float32 unless a caller switches it on.
_FLOAT64 = False


def set_float64(enabled: bool) -> None:
    """Switches the float64 mode on or off for the process (the
    counterpart of ``jax.config.update('jax_enable_x64', True)``)."""
    global _FLOAT64
    _FLOAT64 = bool(enabled)


def float64_enabled() -> bool:
    """Whether the float64 mode is on."""
    return _FLOAT64


@contextlib.contextmanager
def enable_float64(enabled: bool = True):
    """The float64 mode inside a ``with`` block (the counterpart of
    ``jax.enable_x64(True)``); the previous setting returns on exit."""
    prev = _FLOAT64
    set_float64(enabled)
    try:
        yield
    finally:
        set_float64(prev)


def device_dtype(cost_type: str = 'float64') -> torch.dtype:
    """Device dtype for a reference ``cost_type`` tag, by the JAX
    package's rule (``tnco_tpu/ops/bitops.py:22-40``): 'float32' gives
    float32; the wider tags ('float64', 'float128', 'float1024') give
    float64 while the float64 mode is on (:func:`enable_float64`,
    :func:`set_float64`) and float32, with exact host bigint audits,
    otherwise.
    """
    if str(cost_type) == 'float32':
        return torch.float32
    return torch.float64 if _FLOAT64 else torch.float32


def pad_log2_dims(log2_dims, n_lanes: int, dtype=torch.float32,
                  device='cpu') -> torch.Tensor:
    """Pads a ``log2_dims[n_inds]`` table to ``[n_lanes * 32]`` with zeros.

    A host table builder, so ``device`` defaults to the CPU, unlike the
    port's entry points: it runs no engine, and most callers turn the
    table into numpy for a batch builder or move it to their engine's
    device themselves."""
    log2_dims = np.asarray(log2_dims, dtype=np.float64)
    out = np.zeros(n_lanes * LANE_BITS, dtype=np.float64)
    out[:log2_dims.shape[0]] = log2_dims
    return torch.as_tensor(out, dtype=dtype, device=device)


def as_lanes(lanes, device) -> torch.Tensor | None:
    """Lane words as an ``int32`` tensor on ``device``: a ``uint32``
    numpy array is viewed as its int32 bit patterns, a tensor is moved;
    None stays None."""
    if lanes is None:
        return None
    if not isinstance(lanes, torch.Tensor):
        lanes = np.ascontiguousarray(lanes, dtype=np.uint32).view(np.int32)
        lanes = torch.from_numpy(lanes.copy())
    return lanes.to(device=device, dtype=torch.int32)


def pairwise_sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the LAST axis with the pinned pairwise-halving order.

    Pads with exact zeros to a power of two and adds the two halves until
    one element remains — the same per-element operation tree as
    ``tnco_tpu.ops.bitops.pairwise_sum_last``.
    """
    n = x.shape[-1]
    if n == 0:
        return x.new_zeros(x.shape[:-1])
    p = 1 << (n - 1).bit_length() if n > 1 else 1
    if p != n:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (p - n,))], dim=-1)
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def expand_bits(lanes: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """``int32[..., W]`` -> ``dtype[..., W*32]`` 0/1 expansion (bit ``s``
    of word ``w`` at ``32*w + s``)."""
    sh = torch.arange(LANE_BITS, dtype=torch.int32, device=lanes.device)
    bits = (lanes[..., :, None] >> sh) & 1
    return bits.reshape(*lanes.shape[:-1],
                        lanes.shape[-1] * LANE_BITS).to(dtype)


def width(lanes: torch.Tensor,
          log2_dims_padded: torch.Tensor) -> torch.Tensor:
    """Sum of log2 dims over set bits of ``int32[..., W]`` lane sets, in
    the pinned pairwise order of ``tnco_tpu/ops/bitops.py:85-94``."""
    return pairwise_sum_last(
        expand_bits(lanes, log2_dims_padded.dtype) * log2_dims_padded)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-word set-bit count of int32 bit patterns (SWAR), ``int32``.

    Every shift is masked so the sign extension of ``>>`` on int32 never
    leaks into the count, and the sign bit is counted apart so no step
    overflows int32.
    """
    sign = (x >> 31) & 1
    x = x & 0x7FFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return (x & 0x3F) + sign


def _on_own_device(lanes) -> torch.Tensor:
    """Lane words as int32 on the device they lie on (host for numpy),
    in their own shape (0-d included)."""
    if isinstance(lanes, torch.Tensor):
        return as_lanes(lanes, lanes.device)
    return as_lanes(lanes, 'cpu').reshape(np.shape(lanes))


def any_bits(lanes) -> torch.Tensor:
    """True if any bit is set (reduction over the lane axis; a 0-d word
    is its own set), as ``tnco_tpu/ops/bitops.py:97-102``."""
    lanes = _on_own_device(lanes)
    return (lanes != 0).any(dim=-1) if lanes.ndim else lanes != 0


def popcount(lanes) -> torch.Tensor:
    """Number of set bits over the lane axis, ``int32[...]``, as
    ``tnco_tpu/ops/bitops.py:105-108``."""
    return popcount32(_on_own_device(lanes)).sum(dim=-1, dtype=torch.int32)

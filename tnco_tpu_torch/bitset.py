"""Host-side bitset: set-of-indices as a fixed-size bitstring.

Plays the role of the reference's ``boost::dynamic_bitset`` subclass
(reference: include/tnco/bitset.hpp:33-185 and tnco/bitset.py:24-88) but is
backed by a Python ``int`` mask — exact, hashable, picklable — with lossless
conversion to/from the ``uint32`` lane arrays used by the device kernels.

String codec matches the reference (bitset.hpp:40-46): character ``j`` of the
string is bit ``j`` (``'01'`` means bit 1 set).
"""

from collections.abc import Callable
from typing import Any

import numpy as np

__all__ = ['Bitset', 'pack_lanes', 'unpack_lanes', 'n_lanes']

LANE_BITS = 32


def n_lanes(n_bits: int) -> int:
    """Number of ``uint32`` lanes needed for ``n_bits`` bits (at least 1)."""
    return max(1, -(-int(n_bits) // LANE_BITS))


def pack_lanes(mask: int, size: int, width: int | None = None) -> np.ndarray:
    """Packs an int bitmask into a ``uint32[W]`` lane array."""
    w = n_lanes(size) if width is None else width
    out = np.zeros(w, dtype=np.uint32)
    for i in range(w):
        out[i] = (mask >> (LANE_BITS * i)) & 0xFFFFFFFF
    return out


def unpack_lanes(lanes: np.ndarray) -> int:
    """Unpacks a ``uint32[W]`` lane array into an int bitmask."""
    mask = 0
    for i, word in enumerate(np.asarray(lanes, dtype=np.uint32).ravel()):
        mask |= int(word) << (LANE_BITS * i)
    return mask


class Bitset:
    """Fixed-size set of bit positions with set algebra.

    Args:
        bits: Either a bit string (``'0110'``, char j = bit j), an iterable of
            positions (requires ``n``), another ``Bitset``, or an int mask
            (requires ``n``).
        n: Number of bits (required unless ``bits`` is a string or Bitset).

    Examples:
        >>> from tnco_tpu_torch.bitset import Bitset
        >>> b = Bitset([0, 2], n=4)
        >>> str(b)
        '1010'
        >>> (b | Bitset([1], n=4)).positions()
        (0, 1, 2)
    """

    __slots__ = ('_mask', '_n')

    def __init__(self, bits: Any = None, n: int | None = None) -> None:
        if isinstance(bits, Bitset):
            if n is not None and int(n) != bits._n:
                raise ValueError("'n' is not consistent with 'bits'.")
            self._mask, self._n = bits._mask, bits._n
            return
        if isinstance(bits, str):
            if n is not None and int(n) != len(bits):
                raise ValueError("'n' is not consistent with 'bits'.")
            if any(c not in '01' for c in bits):
                raise ValueError("'bits' must be a string of '0'/'1'.")
            self._n = len(bits)
            self._mask = sum(1 << i for i, c in enumerate(bits) if c == '1')
            return
        if bits is None:
            if n is None:
                raise ValueError("'n' must be provided.")
            self._n = int(n)
            self._mask = 0
            return
        if isinstance(bits, (int, np.integer)):
            if n is None:
                raise ValueError("'n' must be provided with an int mask.")
            self._n = int(n)
            if bits < 0 or bits >> self._n:
                raise ValueError("mask does not fit in 'n' bits.")
            self._mask = int(bits)
            return
        # Iterable of positions
        positions = tuple(int(x) for x in bits)
        if n is None:
            raise ValueError("'n' must be provided with positions.")
        self._n = int(n)
        mask = 0
        for p in positions:
            if not 0 <= p < self._n:
                raise ValueError("'n' is too small.")
            mask |= 1 << p
        self._mask = mask

    # Factories -------------------------------------------------------------
    @classmethod
    def from_mask(cls, mask: int, n: int) -> 'Bitset':
        return cls(mask, n=n)

    @classmethod
    def from_lanes(cls, lanes: np.ndarray, n: int) -> 'Bitset':
        mask = unpack_lanes(lanes) & ((1 << int(n)) - 1 if n else 0)
        return cls(mask, n=n)

    # Accessors --------------------------------------------------------------
    @property
    def mask(self) -> int:
        return self._mask

    def lanes(self, width: int | None = None) -> np.ndarray:
        return pack_lanes(self._mask, self._n, width)

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, pos: int) -> bool:
        if not 0 <= pos < self._n:
            raise IndexError("Index out of range.")
        return bool((self._mask >> pos) & 1)

    def test(self, pos: int) -> bool:
        return self[pos]

    def count(self) -> int:
        return self._mask.bit_count()

    def any(self) -> bool:
        return self._mask != 0

    def positions(self) -> tuple[int, ...]:
        mask, out = self._mask, []
        while mask:
            low = mask & -mask
            out.append(low.bit_length() - 1)
            mask ^= low
        return tuple(out)

    def visit(self, callback: Callable[[int], None]) -> None:
        for p in self.positions():
            callback(p)

    # Mutation-free algebra ---------------------------------------------------
    def _check(self, other: 'Bitset') -> None:
        if not isinstance(other, Bitset):
            raise TypeError("Expected a 'Bitset'.")
        if other._n != self._n:
            raise ValueError("Bitsets must have the same size.")

    def __and__(self, other: 'Bitset') -> 'Bitset':
        self._check(other)
        return Bitset(self._mask & other._mask, n=self._n)

    def __or__(self, other: 'Bitset') -> 'Bitset':
        self._check(other)
        return Bitset(self._mask | other._mask, n=self._n)

    def __xor__(self, other: 'Bitset') -> 'Bitset':
        self._check(other)
        return Bitset(self._mask ^ other._mask, n=self._n)

    def __sub__(self, other: 'Bitset') -> 'Bitset':
        self._check(other)
        return Bitset(self._mask & ~other._mask, n=self._n)

    def __invert__(self) -> 'Bitset':
        return Bitset(~self._mask & ((1 << self._n) - 1), n=self._n)

    def set(self, pos: int) -> 'Bitset':
        """Returns a copy with bit ``pos`` set."""
        if not 0 <= pos < self._n:
            raise IndexError("Index out of range.")
        return Bitset(self._mask | (1 << pos), n=self._n)

    def reset(self, pos: int) -> 'Bitset':
        """Returns a copy with bit ``pos`` cleared."""
        if not 0 <= pos < self._n:
            raise IndexError("Index out of range.")
        return Bitset(self._mask & ~(1 << pos), n=self._n)

    # Predicates --------------------------------------------------------------
    def intersects(self, other: 'Bitset') -> bool:
        self._check(other)
        return bool(self._mask & other._mask)

    def isdisjoint(self, other: 'Bitset') -> bool:
        return not self.intersects(other)

    def issubset(self, other: 'Bitset') -> bool:
        self._check(other)
        return not self._mask & ~other._mask

    def issuperset(self, other: 'Bitset') -> bool:
        self._check(other)
        return other.issubset(self)

    def __le__(self, other: 'Bitset') -> bool:
        return self.issubset(other)

    def __ge__(self, other: 'Bitset') -> bool:
        return self.issuperset(other)

    def __lt__(self, other: 'Bitset') -> bool:
        return self.issubset(other) and self != other

    def __gt__(self, other: 'Bitset') -> bool:
        return self.issuperset(other) and self != other

    def __eq__(self, other: Any) -> bool:
        return (isinstance(other, Bitset) and self._n == other._n and
                self._mask == other._mask)

    def __hash__(self) -> int:
        return hash((self._n, self._mask))

    def __bool__(self) -> bool:
        return self.any()

    # Codecs ------------------------------------------------------------------
    def __str__(self) -> str:
        return ''.join('1' if (self._mask >> i) & 1 else '0'
                       for i in range(self._n))

    def __repr__(self) -> str:
        return f'Bitset({str(self)})'

    def __reduce__(self):
        return type(self), (str(self),)

"""Deterministic insertion-ordered immutable set.

Functional equivalent of the reference's ``tnco/ordered_frozenset.py``
(reference: tnco/ordered_frozenset.py:25-268): an immutable set whose
iteration order is the insertion order, used wherever label order must be
reproducible independent of ``PYTHONHASHSEED``.
"""

from collections.abc import Hashable, Iterable, Iterator, Set
from typing import Any

__all__ = ['OrderedFrozenSet']


class OrderedFrozenSet(Set, Hashable):
    """Immutable set preserving first-insertion order of its elements.

    Deterministic label ordering (independent of PYTHONHASHSEED) is what
    makes runs bitwise reproducible (reference
    tnco/ordered_frozenset.py:25-268).

    Examples:
        >>> from tnco_tpu_torch.ordered_frozenset import OrderedFrozenSet
        >>> s = OrderedFrozenSet(['c', 'a', 'b', 'a'])
        >>> list(s)
        ['c', 'a', 'b']
        >>> list(s | OrderedFrozenSet(['d', 'a']))
        ['c', 'a', 'b', 'd']
        >>> s == frozenset('abc')
        True
    """

    __slots__ = ('_map', '_hash')

    def __init__(self, iterable: Iterable[Any] = ()) -> None:
        # dict preserves insertion order; values unused.
        object.__setattr__(self, '_map', dict.fromkeys(iterable))
        object.__setattr__(self, '_hash', None)

    # Immutability ---------------------------------------------------------
    def __setattr__(self, name: str, value: Any) -> None:
        raise AttributeError(f"'{type(self).__name__}' is immutable.")

    # Set protocol ---------------------------------------------------------
    def __contains__(self, item: Any) -> bool:
        return item in self._map

    def __iter__(self) -> Iterator[Any]:
        return iter(self._map)

    def __len__(self) -> int:
        return len(self._map)

    @classmethod
    def _from_iterable(cls, iterable: Iterable[Any]) -> 'OrderedFrozenSet':
        return cls(iterable)

    # Operators keep deterministic (left-to-right) ordering ----------------
    def __and__(self, other: Iterable[Any]) -> 'OrderedFrozenSet':
        other = other if isinstance(other, (Set, frozenset,
                                            set)) else frozenset(other)
        return self._from_iterable(x for x in self if x in other)

    __rand__ = __and__

    def __or__(self, other: Iterable[Any]) -> 'OrderedFrozenSet':
        out = dict.fromkeys(self._map)
        out.update(dict.fromkeys(other))
        return self._from_iterable(out)

    __ror__ = __or__

    def __sub__(self, other: Iterable[Any]) -> 'OrderedFrozenSet':
        other = other if isinstance(other, (Set, frozenset,
                                            set)) else frozenset(other)
        return self._from_iterable(x for x in self if x not in other)

    def __xor__(self, other: Iterable[Any]) -> 'OrderedFrozenSet':
        other = self._from_iterable(other)
        left = (x for x in self if x not in other)
        right = (x for x in other if x not in self)
        out = dict.fromkeys(left)
        out.update(dict.fromkeys(right))
        return self._from_iterable(out)

    def __eq__(self, other: Any) -> bool:
        # Order-insensitive equality (set semantics).
        if isinstance(other, (OrderedFrozenSet, frozenset, set, Set)):
            return len(self) == len(other) and all(x in other for x in self)
        return NotImplemented

    def __hash__(self) -> int:
        if self._hash is None:
            object.__setattr__(self, '_hash', self._hash_impl())
        return self._hash

    def _hash_impl(self) -> int:
        return Set._hash(frozenset(self._map))

    def __repr__(self) -> str:
        return f'{type(self).__name__}({list(self._map)!r})'

    # Convenience ----------------------------------------------------------
    def union(self, *others: Iterable[Any]) -> 'OrderedFrozenSet':
        out = dict.fromkeys(self._map)
        for other in others:
            out.update(dict.fromkeys(other))
        return self._from_iterable(out)

    def intersection(self, *others: Iterable[Any]) -> 'OrderedFrozenSet':
        out = self
        for other in others:
            out = out & OrderedFrozenSet(other)
        return out

    def difference(self, *others: Iterable[Any]) -> 'OrderedFrozenSet':
        out = self
        for other in others:
            out = out - OrderedFrozenSet(other)
        return out

    def issubset(self, other: Iterable[Any]) -> bool:
        other = frozenset(other)
        return all(x in other for x in self)

    def issuperset(self, other: Iterable[Any]) -> bool:
        return all(x in self for x in other)

    def isdisjoint(self, other: Iterable[Any]) -> bool:
        return not any(x in self for x in other)

    def __reduce__(self):
        return type(self), (tuple(self._map),)

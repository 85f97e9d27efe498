"""Tensor / TensorNetwork data model.

Reference: tnco/app/tn.py:76-362 — frozen dataclasses with shape/dims
consistency checks, hyper-count-derived default outputs, and JSON codecs.
"""

from collections.abc import Iterator
from dataclasses import dataclass
import itertools as its
import json
from types import MappingProxyType
from typing import Any

from tnco_tpu_torch.utils.tensor import asarray
from tnco_tpu_torch.utils.tn import get_hyper_count

__all__ = ['Tensor', 'TensorNetwork']


class JSONEncoder(json.JSONEncoder):
    """JSON codec for TN objects (reference tnco/app/tn.py:35-73)."""

    def default(self, obj) -> Any:
        match obj:
            case complex():
                return '{} + {}j'.format(obj.real, obj.imag)
            case frozenset():
                return tuple(obj)
            case Tensor():
                return dict(
                    inds=obj.inds,
                    dims=obj.dims,
                    array=None if obj.array is None else obj.array.tolist(),
                    tags=obj.tags)
            case TensorNetwork():
                return dict(tensors=obj.tensors,
                            output_inds=obj.output_inds,
                            sparse_inds=obj.sparse_inds)
            case _ if hasattr(obj, 'to_json'):
                return obj.to_json()
            case _:
                return super().default(obj)


def _is_int(x) -> bool:
    try:
        return int(x) == x
    except (ValueError, TypeError):
        return False


@dataclass(frozen=True, repr=False, eq=False)
class Tensor:
    """A single labeled tensor: indices + dims and/or a concrete array.

    Examples:
        >>> import numpy as np
        >>> from tnco_tpu_torch.app import Tensor
        >>> Tensor(array=np.eye(2), inds=('i', 'j')).ndim
        2
    """
    inds: tuple
    dims: tuple | None = None
    array: Any | None = None
    tags: dict | None = None

    def __post_init__(self) -> None:
        if self.dims is None and self.array is None:
            raise ValueError("One of 'dims' or 'array' must be provided.")

        object.__setattr__(self, 'inds', tuple(self.inds))
        if self.array is not None:
            object.__setattr__(self, 'array', asarray(self.array))
        if self.dims is None:
            object.__setattr__(self, 'dims', tuple(self.array.shape))
        else:
            try:
                d = int(self.dims)
            except (TypeError, ValueError):
                object.__setattr__(self, 'dims', tuple(self.dims))
            else:
                if d != self.dims or d < 1:
                    raise ValueError("'dims' must be a positive integer.")
                object.__setattr__(self, 'dims', (d,) * len(self.inds))
        object.__setattr__(self, 'tags',
                           {} if self.tags is None else dict(self.tags))

        if any(not _is_int(d) or d < 1 for d in self.dims):
            raise ValueError("Every dimension must be a positive integer.")
        if len(self.dims) != len(self.inds):
            raise ValueError("Wrong number of 'inds'.")
        if self.array is not None and tuple(self.array.shape) != self.dims:
            raise ValueError("'dims' are not consistent with 'array'.")

    def __eq__(self, other: Any, *, atol: float = 1e-5) -> bool:
        if (self.array is None) ^ (other.array is None):
            return False
        if self.array is not None:
            import numpy as np
            if not np.all(np.abs(np.asarray(self.array) -
                                 np.asarray(other.array)) < atol):
                return False
        return self.inds == other.inds and self.dims == other.dims

    def __repr__(self) -> str:
        extra = '' if self.array is None else \
            f', dtype={self.array.dtype}'
        tags = '' if not self.tags else f', tags={self.tags}'
        shape = None if self.array is None else tuple(self.array.shape)
        return f'Tensor(ndim={self.ndim}, array={shape}{extra}{tags})'

    @property
    def ndim(self) -> int:
        return len(self.dims)

    def to_json(self) -> str:
        return json.dumps(self, cls=JSONEncoder)


@dataclass(frozen=True, repr=False)
class TensorNetwork:
    """A network of labeled tensors with optional output/sparse indices.

    Examples:
        >>> import numpy as np
        >>> from tnco_tpu_torch.app import Tensor, TensorNetwork
        >>> tn = TensorNetwork([Tensor(array=np.eye(2), inds=('i', 'j')),
        ...                     Tensor(array=np.ones(2), inds=('j',))])
        >>> tn.n_tensors
        2
    """
    tensors: tuple
    output_inds: frozenset | None = None
    sparse_inds: frozenset | None = None
    tags: dict | None = None

    def __post_init__(self) -> None:
        object.__setattr__(self, 'tensors', tuple(self.tensors))
        if any(not isinstance(t, Tensor) for t in self.tensors):
            raise ValueError("'tensors' must be a list of valid 'Tensor'.")
        object.__setattr__(
            self, 'sparse_inds',
            frozenset(() if self.sparse_inds is None else self.sparse_inds))

        all_inds = frozenset(
            its.chain.from_iterable(t.inds for t in self.tensors))
        object.__setattr__(self, '_inds', all_inds)

        dims = {}
        for t in self.tensors:
            dims.update(zip(t.inds, t.dims))
        object.__setattr__(self, '_dims', dims)
        if any(t.dims != tuple(dims[x] for x in t.inds)
               for t in self.tensors):
            raise ValueError("Dimensions of 'tensors' are not consistent.")

        hyper_count = get_hyper_count(self.ts_inds)
        if self.output_inds is None:
            if any(c > 1 for c in hyper_count.values()):
                raise ValueError("'output_inds' must be provided if "
                                 "'ts_inds' has hyper-indices.")
            object.__setattr__(
                self, 'output_inds',
                frozenset(x for x, c in hyper_count.items() if c == 0))
        else:
            object.__setattr__(self, 'output_inds',
                               frozenset(self.output_inds))

        if not self.output_inds.issubset(all_inds):
            raise ValueError(
                "'output_inds' contains indices not in 'tensors'.")
        if not self.sparse_inds.issubset(all_inds):
            raise ValueError(
                "'sparse_inds' contains indices not in 'tensors'.")

        object.__setattr__(self, 'tags',
                           dict(() if self.tags is None else self.tags))

    def __repr__(self) -> str:
        return (f'TensorNetwork(n_tensors={self.n_tensors}, '
                f'n_inds={self.n_inds})')

    @property
    def n_tensors(self) -> int:
        return len(self.tensors)

    @property
    def n_inds(self) -> int:
        return len(self._inds)

    @property
    def ts_inds(self):
        return tuple(t.inds for t in self.tensors)

    @property
    def arrays(self):
        return tuple(t.array for t in self.tensors)

    @property
    def ts_tags(self):
        return tuple(t.tags for t in self.tensors)

    @property
    def inds(self) -> frozenset:
        return self._inds

    @property
    def dims(self):
        return MappingProxyType(self._dims)

    def __len__(self) -> int:
        return self.n_tensors

    def __getitem__(self, key: int) -> Tensor:
        return self.tensors[key]

    def __iter__(self) -> Iterator[Tensor]:
        return iter(self.tensors)

    def to_json(self) -> str:
        return json.dumps(self, cls=JSONEncoder)

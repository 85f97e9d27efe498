"""The engines' random draws, on one device or on one rank of a mesh.

The engines that run on a mesh ('batched', 'vmapped', 'multiwalk',
'walks', 'walker') draw their streams from a ``torch.Generator`` with one
of the two calls below, naming the axis of the stream that runs over
replicas.  On a mesh, a runner hands its engine a :class:`BlockGenerator`:
each draw then covers the whole replica axis, as the one-device run
draws it, and keeps the rank's own columns.  So a replica's numbers do
not depend on how the batch is split, and a sharded run equals the
one-device run bitwise (the JAX package's guarantee for its sharded
engines).  The price is that each of ``n`` ranks draws ``n`` times its
own share.
"""

import torch

__all__ = ['BlockGenerator', 'rand', 'randint']


class BlockGenerator:
    """``generator`` as one rank sees it: draws over ``n`` replicas, of
    which the rank keeps the columns ``[lo, hi)``.  Every rank seeds its
    ``generator`` alike, so all of them walk the same stream."""

    def __init__(self, generator: torch.Generator, lo: int, hi: int,
                 n: int) -> None:
        if not 0 <= lo < hi <= n:
            raise ValueError(f"[{lo}, {hi}) is not a block of {n} replicas.")
        self.generator = generator
        self.lo, self.hi, self.n = int(lo), int(hi), int(n)

    @property
    def device(self) -> torch.device:
        return self.generator.device


def _draw(fn, generator, shape, axis):
    if not isinstance(generator, BlockGenerator):
        return fn(tuple(shape), generator)
    shape = list(shape)
    if shape[axis] != generator.hi - generator.lo:
        raise ValueError(f"A draw of {shape[axis]} replicas on a block of "
                         f"{generator.hi - generator.lo}.")
    shape[axis] = generator.n
    full = fn(tuple(shape), generator.generator)
    return full.narrow(axis, generator.lo,
                       generator.hi - generator.lo).contiguous()


def rand(generator, shape, axis: int, dtype=torch.float32) -> torch.Tensor:
    """``torch.rand(shape)`` from ``generator`` on its device; ``axis`` is
    the replica axis of ``shape``."""
    return _draw(lambda s, g: torch.rand(s, generator=g, device=g.device,
                                         dtype=dtype),
                 generator, shape, axis)


def randint(generator, low: int, high: int, shape, axis: int,
            dtype=torch.int32) -> torch.Tensor:
    """``torch.randint(low, high, shape)`` from ``generator`` on its
    device; ``axis`` is the replica axis of ``shape``."""
    return _draw(lambda s, g: torch.randint(low, high, s, generator=g,
                                            device=g.device, dtype=dtype),
                 generator, shape, axis)

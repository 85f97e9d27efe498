"""Walk draws and the acceptance-rule predicate shared by the walk
engines (from ``tnco_tpu/kernels/sa_multiwalk.py:224,373-383``)."""

import torch

__all__ = ['draw_walks']


def _chains_lt(cfg) -> bool:
    """Whether the acceptance rule depends on the total — i.e. whether
    ``accept_rule='chained'`` differs from 'round' at all."""
    return cfg.prob_kind in ('mh', 'greedy')


def draw_walks(generator: torch.Generator, n_leaves: int, b: int, p: int,
               n_bits: int, dtype=torch.float32):
    """One iteration's draws on the generator's device.

    The counterpart of ``sa_multiwalk._draws(keys, n, p, dtype, 5)`` plus
    the reslice jitter: ``leaf [B, P]`` in ``[0, n_leaves)``, ``rand_bit
    [B, P]`` (bool), ``u [B, P]`` in ``[0, 1)`` and ``jitter [n_bits, B]``
    in ``[0, 1)``.  torch's generator gives other numbers than JAX's
    threefry from the same seed; tests inject the JAX draws instead.
    """
    dev = generator.device
    leaf = torch.randint(0, n_leaves, (b, p), generator=generator,
                         device=dev, dtype=torch.int32)
    rand_bit = torch.randint(0, 2, (b, p), generator=generator, device=dev,
                             dtype=torch.int32) != 0
    u = torch.rand((b, p), generator=generator, device=dev, dtype=dtype)
    jitter = torch.rand((n_bits, b), generator=generator, device=dev,
                        dtype=dtype)
    return {'leaf': leaf, 'rand_bit': rand_bit, 'u': u, 'jitter': jitter}

"""tnco-tpu on PyTorch and CUDA: the contraction-order optimizer on an
NVIDIA Hopper card.

A second package beside :mod:`tnco_tpu` (the JAX/TPU reference).  It
imports ``torch`` and numpy only — never ``jax`` and nothing of
``tnco_tpu``; the host modules it needs are its own copies.  The layout
mirrors the reference package so each counterpart is found by path:

- :mod:`tnco_tpu_torch.bitset`, :mod:`tnco_tpu_torch.ctree` — data model.
- :mod:`tnco_tpu_torch.ops` — bitset and log2-cost primitives.
- :mod:`tnco_tpu_torch.kernels` — the SA engines and their hand-written
  Hopper kernels (``csrc/*.cu``, built with ``nvcc`` at first use).
- :mod:`tnco_tpu_torch.optimize` — the cost models, the single-optimizer
  wrappers and the acceptance probabilities.
- :mod:`tnco_tpu_torch.parallel` — the replica runners, the population
  operators, checkpoints and the host fan-out.
- :mod:`tnco_tpu_torch.app` — ``Optimizer``, ``load_tn``, the CLI and the
  sampler.
- :mod:`tnco_tpu_torch.utils` — host utilities: networks, circuits, the
  greedy path finder, profiling, the compile cache.
- :mod:`tnco_tpu_torch.testing` — the test and smoke-run helpers.

Device rule: every entry point takes ``device=None``, which means
``'cuda'``; without CUDA it raises and asks for ``device='cpu'``.  It
never falls back to the CPU on its own.
"""

from tnco_tpu_torch.device import resolve_device

__version__ = '0.1.0'

__all__ = ['resolve_device']

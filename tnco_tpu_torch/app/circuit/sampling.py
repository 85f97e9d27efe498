"""Bitstring sampling via the Bravyi-Gosset-Liu algorithm (the port's copy
of ``tnco_tpu/app/circuit/sampling.py``).

Samples measurement outcomes from a circuit of 1-qubit gates and classical
(permutation) operations without computing marginals, following
"How to Simulate Quantum Measurement without Computing Marginals",
PRL 128, 220503 (2022).  Reference implementation:
tnco/app/circuit/sampling.py:46-553.

Structure: one partial tensor network per non-classical gate prefix is
optimized once (reusable, pickleable ``SamplingIntermediateState``); the
sampling loop then contracts two amplitudes per gate to get the flip
probability, while classical gates permute the bitstring directly.

Each prefix network is optimized by the port's ``Optimizer`` on its
device (:class:`Sampler`'s ``device``: None means the card; ``'cpu'``
must be asked for).  The amplitude contractions run on the host in numpy
(:func:`tnco_tpu_torch.utils.tn.contract` and ``contract_sliced``), as in
the JAX package, whose ``tensordot`` converts both operands to numpy.
"""

from collections import defaultdict
from dataclasses import dataclass
import math
from random import Random
from typing import Any

import numpy as np

from tnco_tpu_torch.app import Optimizer, Tensor, TensorNetwork
from tnco_tpu_torch.utils.circuit import load
from tnco_tpu_torch.utils.tn import contract, contract_sliced

__all__ = ['Sampler', 'sample', 'SamplingIntermediateState']


def is_classical_operation(m) -> bool:
    """True if ``m`` permutes basis states (up to per-element phases).

    Reference: sampling.py:46-75.
    """
    m = np.asarray(m)
    if m.ndim != 2 or m.shape[0] != m.shape[1]:
        return False
    n = math.log2(m.shape[0])
    if int(n) != n:
        return False
    row_pos, col_pos = np.where(m)
    if not (sorted(row_pos) == sorted(col_pos) == list(range(m.shape[0]))):
        return False
    return bool(np.all(np.abs(m[m != 0]) == 1))


@dataclass(init=False, eq=False, repr=False, frozen=True)
class SamplingIntermediateState:
    """Reusable checkpoint of the expensive optimization phase.

    ``data`` holds one entry per circuit operation: either
    ``(None, None, permutation_matrix, None, op_qubits)`` for classical ops
    or ``(tn, best_result, arrays, output_qubits, op_qubits)`` for quantum
    gates (reference sampling.py:78-99).  ``qubits`` is the set of the
    circuit's qubits; :attr:`qubit_order` is the default order of a
    sample's bits.
    """

    def __init__(self, data, qubits):
        object.__setattr__(self, 'data', tuple(data))
        object.__setattr__(self, 'qubits', frozenset(qubits))

    def __getitem__(self, k):
        return self.data[k]

    def __iter__(self):
        return iter(self.data)

    def __len__(self):
        return len(self.data)

    @property
    def qubit_order(self) -> tuple:
        """The qubits in order of first appearance in the circuit (each
        entry's ``op_qubits``, in circuit order).  The JAX package orders
        them by iterating the frozenset ``qubits``, which follows the
        process's string hash seed; this order does not, and a state
        pickled without it still has its entries to derive it from."""
        return tuple(dict.fromkeys(q for entry in self.data
                                   for q in entry[-1]))


def sample(circuit,
           optimizer,
           n_samples: int = 1,
           *,
           simplify: bool = True,
           use_matrix_commutation: bool = True,
           decompose_hyper_inds: bool = True,
           fuse: float = 4,
           qubit_order=None,
           normalize: bool = True,
           return_intermediate_state_only: bool = False,
           dtype: Any | None = None,
           optimization_backend: str | None = None,
           contraction_backend: str | None = None,
           seed: int | None = None,
           verbose: int = 0,
           **optimize_params):
    """Samples bitstrings from ``circuit`` (see module docstring).

    ``optimizer`` optimizes the prefix networks on its own device (unused,
    and may be None, when ``circuit`` is an intermediate state: the
    sampling loop runs on the host).  ``optimization_backend`` is taken
    for the reference's signature and not used here: the optimizer
    carries its own ``backend`` (:class:`Sampler` passes it there).
    ``contraction_backend`` is the amplitudes' array backend (None or
    'numpy', or 'torch' on the CPU).

    Returns ``(hits_by_bitstring, qubit_order)``, or the intermediate state
    when ``return_intermediate_state_only``.
    """
    # Dispatch third-party circuits
    mod = type(circuit).__module__
    if mod.startswith('cirq.'):
        from tnco_tpu_torch.utils.circuit import cirq_to_gates
        circuit = cirq_to_gates(circuit, dtype=dtype)
    elif mod.startswith('qiskit.'):
        from tnco_tpu_torch.utils.circuit import qiskit_to_gates
        circuit = qiskit_to_gates(circuit, dtype=dtype)

    qubit_order = None if qubit_order is None else tuple(qubit_order)

    if not isinstance(circuit, SamplingIntermediateState):
        circuit = [(np.asarray(m, dtype=dtype), tuple(qs))
                   for m, qs in circuit]

        if not all(
                len(qs) == 1 or is_classical_operation(m)
                for m, qs in circuit):
            raise ValueError(
                "Only 1-qubit operations and linear transformations "
                "(with or without phase change) are allowed.")

        qubits = frozenset(q for _, qs in circuit for q in qs)
        if qubit_order is not None and frozenset(qubit_order) != qubits:
            raise ValueError(
                "'qubit_order' is not consistent with qubits in 'circuit'.")

        # One partial TN per non-classical gate prefix
        # (reference sampling.py:193-216).
        entries = []
        for i, (m, qs) in enumerate(circuit):
            if is_classical_operation(m):
                entries.append((None, None, (m != 0).astype(int), None, qs))
                continue
            arrays, ts_inds, output_inds = load(
                circuit[:i + 1],
                initial_state='0',
                final_state=None,
                simplify=simplify,
                use_matrix_commutation=use_matrix_commutation,
                decompose_hyper_inds=decompose_hyper_inds,
                fuse=fuse,
                dtype=dtype)
            output_inds = tuple(output_inds)
            # Placeholder rank-1 tensors: the bitstring projectors that the
            # sampling loop plugs in per sample.
            tensors = [Tensor(xs, dims=2) for xs in ts_inds]
            tensors += [Tensor((x,), dims=2) for x in output_inds]
            tn = TensorNetwork(tensors, output_inds=())
            output_qubits = tuple(x[0] for x in output_inds)
            entries.append((tn, arrays, output_qubits, qs))

        def optimize(tn):
            tn_, res = optimizer.optimize(tn,
                                          fuse=False,
                                          decompose_hyper_inds=False,
                                          **optimize_params)
            return sorted(res, key=lambda x: x.cost)[0]

        def finalize(entry):
            if entry[0] is None:
                _, _, perm, _, op_qubits = entry
                return (None, None, perm, None, op_qubits)
            tn, arrays, output_qubits, op_qubits = entry
            return (tn, optimize(tn), list(arrays), output_qubits,
                    op_qubits)

        partial_tn = SamplingIntermediateState(
            (finalize(entry) for entry in entries), qubits=qubits)
    else:
        partial_tn = circuit

    if return_intermediate_state_only:
        return partial_tn

    rng = Random(seed)

    if qubit_order is not None:
        if frozenset(qubit_order) != partial_tn.qubits:
            raise ValueError(
                "'qubit_order' is not consistent with qubits in 'circuit'.")
        qubits = qubit_order
    else:
        qubits = partial_tn.qubit_order
    n_qubits = len(qubits)

    sampled = defaultdict(int)

    for _ in range(n_samples):
        bitstring = np.zeros(n_qubits, dtype=int)

        for tn, result, arrays, output_qubits, op_qubits in partial_tn:
            if tn is None:
                # Classical op: permute the sub-bitstring
                # (reference sampling.py:278-300).
                locs = [qubits.index(q) for q in op_qubits]
                sub = np.zeros(2**len(op_qubits), dtype=int)
                sub[int(''.join(map(str, bitstring[locs])), 2)] = 1
                (new_idx,) = np.where((arrays @ sub) % 2)[0]
                bits = list(map(int,
                                bin(int(new_idx))[2:].zfill(len(op_qubits))))
                bitstring[locs] = bits
                continue

            # Quantum gate: two amplitude contractions
            # (reference sampling.py:302-346).
            (qubit_loc,) = (qubits.index(q) for q in op_qubits)

            projectors = [
                np.asarray([0, 1] if bitstring[qubits.index(q)] else [1, 0],
                           dtype=float)
                for q in output_qubits
            ]

            # Sorted so the slice-sum order (and hence float rounding) is
            # independent of the hash seed.
            res_slices = tuple(sorted(getattr(result, 'slices', ()) or (),
                                      key=repr))

            def amplitude(projs):
                ts = list(arrays) + projs
                if res_slices:
                    # Width-capped optimization: execute the sliced
                    # contraction (one projected pass per slice
                    # assignment, summed) — beyond-reference capability.
                    _, _, (amp,) = contract_sliced(
                        result.path, tn.ts_inds, res_slices,
                        output_inds=(), arrays=ts,
                        backend=contraction_backend)
                else:
                    _, _, (amp,) = contract(result.path, tn.ts_inds,
                                            output_inds=(), arrays=ts,
                                            backend=contraction_backend)
                return abs(complex(np.asarray(amp)))**2

            prob_0 = amplitude(projectors)

            flip_at = output_qubits.index(op_qubits[0])
            projectors[flip_at] = np.asarray(
                [1, 0] if bitstring[qubit_loc] else [0, 1], dtype=float)
            prob_1 = amplitude(projectors)

            if rng.random() < prob_1 / (prob_0 + prob_1):
                bitstring[qubit_loc] ^= 1

        sampled[''.join(map(str, bitstring))] += 1

    if normalize:
        sampled = {b: n / n_samples for b, n in sampled.items()}

    return (dict(sorted(sampled.items(), key=lambda kv: kv[1],
                        reverse=True)), qubits)


@dataclass(frozen=True)
class Sampler:
    """Front-end for BGL bitstring sampling (reference sampling.py:422-553).

    Args mirror :func:`tnco_tpu_torch.app.Optimizer`
    (``optimization_backend`` is its ``backend``, the arrays' backend of
    the networks it loads); ``device`` (None means the card) is where the
    prefix networks are optimized.  Finite
    ``max_width`` IS supported (the reference raises NotImplementedError,
    sampling.py:479-481): the width-capped optimizer's sliced amplitude
    networks are executed one projected pass per slice assignment and
    summed (:func:`tnco_tpu_torch.utils.tn.contract_sliced`).
    """

    max_width: float | None = None
    n_jobs: int = -1
    width_type: str = 'float32'
    cost_type: str = 'float64'
    atol: float = 1e-5
    dtype: Any | None = None
    optimization_backend: str | None = None
    device: Any | None = None
    seed: int | None = None
    verbose: int = 0

    def __post_init__(self):
        object.__setattr__(self, '_rng', Random(self.seed))
        optimizer = Optimizer(max_width=self.max_width,
                              n_jobs=self.n_jobs,
                              width_type=self.width_type,
                              cost_type=self.cost_type,
                              atol=self.atol,
                              dtype=self.dtype,
                              backend=self.optimization_backend,
                              seed=self._rng.randrange(2**32),
                              verbose=self.verbose - 5,
                              device=self.device)
        object.__setattr__(self, '_optimizer', optimizer)
        # Finite max_width is SUPPORTED here (the reference raises
        # NotImplementedError, sampling.py:479-481): sliced amplitude
        # networks are executed per slice assignment and summed
        # (utils.tn.contract_sliced).

    def sample(self,
               circuit,
               n_samples: int = 1,
               *,
               simplify: bool = True,
               use_matrix_commutation: bool = True,
               decompose_hyper_inds: bool = True,
               fuse: float = 4,
               qubit_order=None,
               normalize: bool = True,
               return_intermediate_state_only: bool = False,
               contraction_backend: str | None = None,
               **optimize_params):
        """Samples ``n_samples`` bitstrings (see :func:`sample`)."""
        return sample(
            circuit,
            optimizer=self._optimizer,
            n_samples=n_samples,
            simplify=simplify,
            use_matrix_commutation=use_matrix_commutation,
            decompose_hyper_inds=decompose_hyper_inds,
            fuse=fuse,
            qubit_order=qubit_order,
            normalize=normalize,
            return_intermediate_state_only=return_intermediate_state_only,
            dtype=self.dtype,
            optimization_backend=self.optimization_backend,
            contraction_backend=contraction_backend,
            seed=self._rng.randrange(2**32),
            verbose=self.verbose,
            **optimize_params)

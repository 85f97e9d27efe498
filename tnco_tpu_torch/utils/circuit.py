"""Quantum-circuit utilities: gate algebra and circuit -> TN conversion
(the port's copy of ``tnco_tpu/utils/circuit.py``, host numpy).

Re-implements the reference circuit toolbox (tnco/utils/circuit.py:41-604):
``commute``/``same`` gate predicates, the ``load`` converter (inverse-pair
cancellation through commuting prefixes, per-gate ``(qubit, moment)``
indices, initial/final state attachment, hyper-index decomposition with
Kronecker-delta reinsertion, optional fusion), and cirq/qiskit adapters
behind gated imports.
"""

from collections import defaultdict
from collections.abc import Iterable
import functools as fts
import itertools as its
import math
from random import Random
from typing import Any

import numpy as np

from tnco_tpu_torch.ordered_frozenset import OrderedFrozenSet
import tnco_tpu_torch.utils.tensor as tensor_utils
import tnco_tpu_torch.utils.tn as tn_utils

__all__ = ['load', 'commute', 'same', 'cirq_to_gates', 'qiskit_to_gates']


def _check_gate(array, qubits) -> None:
    if not (len(qubits) > 0 and array.ndim == 2 and
            array.shape[0] == array.shape[1] and
            array.shape[0] == 2**len(qubits) and
            len(set(qubits)) == len(qubits)):
        raise ValueError("gate is not valid.")


def commute(gate_a, gate_b, *, use_matrix_commutation: bool = True,
            atol: float = 1e-8) -> bool:
    """True if two gates commute (qubit overlap, optionally exact algebra).

    Reference: tnco/utils/circuit.py:41-134.

    Examples:
        >>> import numpy as np
        >>> from tnco_tpu_torch.utils.circuit import commute
        >>> X = np.array([[0, 1], [1, 0]])
        >>> Z = np.array([[1, 0], [0, -1]])
        >>> commute((X, (0,)), (Z, (0,)))
        False
        >>> commute((X, (0,)), (X, (0,)))
        True
    """
    array_a, qubits_a = np.asarray(gate_a[0]), tuple(gate_a[1])
    array_b, qubits_b = np.asarray(gate_b[0]), tuple(gate_b[1])
    _check_gate(array_a, qubits_a)
    _check_gate(array_b, qubits_b)

    shared = frozenset(qubits_a) & frozenset(qubits_b)
    if not shared:
        return True
    if not use_matrix_commutation:
        return False

    all_qubits = tuple(dict.fromkeys(qubits_a + qubits_b))

    def apply_then(first, qs_f, second, qs_s):
        """Tensor of (second . first) with open (q,'i')/(q,'f') legs."""
        xs_f = tuple(
            its.chain(((q, 'mid' if q in shared else 'f') for q in qs_f),
                      ((q, 'i') for q in qs_f)))
        xs_s = tuple(
            its.chain(((q, 'f') for q in qs_s),
                      ((q, 'mid' if q in shared else 'i') for q in qs_s)))
        arr, labels = tensor_utils.tensordot(
            (first.reshape((2,) * 2 * len(qs_f)), xs_f),
            (second.reshape((2,) * 2 * len(qs_s)), xs_s))
        want = tuple(
            its.chain(((q, 'f') for q in all_qubits),
                      ((q, 'i') for q in all_qubits)))
        return arr.transpose(tuple(labels.index(x) for x in want))

    ab = apply_then(array_a, qubits_a, array_b, qubits_b)  # B after A
    ba = apply_then(array_b, qubits_b, array_a, qubits_a)  # A after B
    return np.allclose(ab, ba, atol=atol)


def same(gate_a, gate_b, *, atol: float = 1e-8) -> bool:
    """True if two gates are equal up to a global phase.

    Reference: tnco/utils/circuit.py:137-203.

    Examples:
        >>> import numpy as np
        >>> from tnco_tpu_torch.utils.circuit import same
        >>> X = np.array([[0, 1], [1, 0]])
        >>> same((X, (0,)), (1j * X, (0,)))
        True
    """
    array_a, qubits_a = np.asarray(gate_a[0]), tuple(gate_a[1])
    array_b, qubits_b = np.asarray(gate_b[0]), tuple(gate_b[1])
    _check_gate(array_a, qubits_a)
    _check_gate(array_b, qubits_b)

    if len(qubits_a) != len(qubits_b) or any(q not in qubits_a
                                             for q in qubits_b):
        return False

    # Align B's qubit order to A's
    order = tuple(qubits_b.index(q) for q in qubits_a)
    order += tuple(x + len(qubits_a) for x in order)
    array_b = array_b.reshape((2,) * 2 * len(qubits_b)).transpose(
        order).reshape((2**len(qubits_b), -1))

    pos_a = np.abs(array_a) > atol
    pos_b = np.abs(array_b) > atol
    if not np.array_equal(pos_a, pos_b):
        return False
    if not pos_a.any():
        return True
    ratio = array_a[pos_a].ravel() / array_b[pos_b].ravel()
    return np.allclose(ratio, ratio[0], atol=atol)


_TOKEN_STATES = {
    '0': np.array([1.0, 0.0]),
    '1': np.array([0.0, 1.0]),
    '+': np.array([1.0, 1.0]) / math.sqrt(2),
    '-': np.array([1.0, -1.0]) / math.sqrt(2),
}


def _get_state(state, tag, qubits, dtype, atol):
    """Normalizes an initial/final state spec to {(q, tag): vector}."""
    if state is None:
        return {}
    if isinstance(state, str):
        if state not in _TOKEN_STATES:
            raise ValueError("State has not supported tokens.")
        vec = np.asarray(_TOKEN_STATES[state], dtype=dtype)
        return {(q, tag): vec for q in qubits}
    if isinstance(state, dict):
        out = {}
        for q, x in state.items():
            if q not in qubits:
                continue
            if isinstance(x, str):
                if x not in _TOKEN_STATES:
                    raise ValueError("State has not supported tokens.")
                vec = np.asarray(_TOKEN_STATES[x], dtype=dtype)
            else:
                vec = np.asarray(x, dtype=dtype).reshape(-1)
            if vec.shape != (2,) or abs(np.linalg.norm(vec) - 1) > atol:
                raise ValueError("State is not properly normalized.")
            out[(q, tag)] = vec
        return out
    raise NotImplementedError("State not supported.")


def _kron_delta(n: int, dtype):
    """n-leg Kronecker delta (all legs equal)."""
    delta = np.zeros((2,) * n, dtype=dtype)
    delta[(0,) * n] = 1
    delta[(1,) * n] = 1
    return delta


def load(circuit,
         *,
         initial_state='0',
         final_state='0',
         simplify: bool = True,
         use_matrix_commutation: bool = True,
         decompose_hyper_inds: bool = True,
         fuse: float = 4,
         dtype: Any | None = None,
         atol: float = 1e-8,
         backend: str | None = None,
         seed: int | None = None,
         verbose: int = 0,
         **kwargs):
    """Converts a gate list into a tensor network.

    Behavior-parity port of the reference converter
    (tnco/utils/circuit.py:206-516):

    1. iterated simplification: a new gate cancels against the most recent
       earlier gate equal to its adjoint, provided every gate in between
       commutes with it (circuit.py:348-399);
    2. identities for idle qubits (circuit.py:406-409);
    3. per-gate tensor indices ``(qubit, moment)``, open ends relabeled
       ``(q, 'i')`` / ``(q, 'f')`` (circuit.py:411-438);
    4. initial/final states (tokens '01+-' or 1x2 vectors; final state is
       conjugated) attached as rank-1 tensors (circuit.py:441-451);
    5. optional hyper-index decomposition, incl. reinsertion of Kronecker
       deltas for output-output identifications (circuit.py:459-495);
    6. optional fusion up to ``fuse`` width.

    Returns:
        ``(arrays, ts_inds, output_inds)``.
    """
    # Dispatch on third-party circuit types
    mod = type(circuit).__module__
    if mod.startswith('cirq.'):
        return load(cirq_to_gates(circuit, dtype=dtype),
                    initial_state=initial_state, final_state=final_state,
                    simplify=simplify,
                    use_matrix_commutation=use_matrix_commutation,
                    decompose_hyper_inds=decompose_hyper_inds, fuse=fuse,
                    dtype=dtype, atol=atol, backend=backend, seed=seed,
                    verbose=verbose, **kwargs)
    if mod.startswith('qiskit.'):
        return load(qiskit_to_gates(circuit, dtype=dtype),
                    initial_state=initial_state, final_state=final_state,
                    simplify=simplify,
                    use_matrix_commutation=use_matrix_commutation,
                    decompose_hyper_inds=decompose_hyper_inds, fuse=fuse,
                    dtype=dtype, atol=atol, backend=backend, seed=seed,
                    verbose=verbose, **kwargs)

    circuit = tuple(
        (np.asarray(a, dtype=dtype), tuple(qs)) for a, qs in circuit)

    qubits = kwargs.pop(
        '_qubits',
        OrderedFrozenSet(
            its.chain.from_iterable(qs for _, qs in circuit)))
    if kwargs:
        raise TypeError('Got unexpected keyword argument(s).')

    same_ = fts.partial(same, atol=atol)
    commute_ = fts.partial(commute,
                           use_matrix_commutation=use_matrix_commutation,
                           atol=atol)

    if simplify:
        all_gates = []
        changes = False
        for gate in circuit:
            gate_adj = (gate[0].conj().T, gate[1])
            # Scan backwards through gates commuting with the new one;
            # stop at the first adjoint match (cancel) or blocker (append).
            status = False
            cancel_at = None
            for i, prev in enumerate(reversed(all_gates)):
                if same_(prev, gate_adj):
                    status, cancel_at = True, i
                    break
                if not commute_(prev, gate):
                    break
            if status:
                del all_gates[len(all_gates) - cancel_at - 1]
                changes = True
            else:
                all_gates.append(gate)
        if changes:
            return load(all_gates,
                        initial_state=initial_state,
                        final_state=final_state,
                        simplify=simplify,
                        use_matrix_commutation=use_matrix_commutation,
                        decompose_hyper_inds=decompose_hyper_inds,
                        fuse=fuse,
                        dtype=dtype,
                        atol=atol,
                        backend=backend,
                        seed=Random(seed).randrange(2**32),
                        verbose=verbose,
                        _qubits=qubits)
    else:
        all_gates = list(circuit)

    # Identities for idle qubits
    present = OrderedFrozenSet(
        its.chain.from_iterable(qs for _, qs in circuit))
    for missing in qubits.difference(present):
        all_gates.append((np.eye(2, dtype=dtype), (missing,)))

    # Per-gate tensors with (qubit, moment) indices: outputs first, inputs
    # second (row index of the matrix = output leg).
    qubit_map = defaultdict(int)
    arrays = []
    ts_inds = []
    for array, qs in all_gates:
        moments = tuple((q, qubit_map[q]) for q in qs)
        arrays.append(np.asarray(array).reshape((2,) * 2 * len(qs)))
        ts_inds.append(
            tuple((q, x + 1) for q, x in moments) + moments)
        for q in qs:
            qubit_map[q] += 1

    # Open ends: (q, last) -> (q, 'f'), (q, 0) -> (q, 'i')
    output_inds = OrderedFrozenSet(
        (q, x) for q, x in qubit_map.items()).union(
            (q, 0) for q in qubits)
    output_inds_map = {
        x: (x[0], 'i' if x[1] == 0 else 'f') for x in output_inds
    }
    output_inds = OrderedFrozenSet(output_inds_map[x] for x in output_inds)
    ts_inds = [tuple(output_inds_map.get(x, x) for x in xs)
               for xs in ts_inds]

    # Attach initial / final states (final state conjugated)
    initial = _get_state(initial_state, 'i', qubits, dtype, atol)
    final = {
        k: a.conj()
        for k, a in _get_state(final_state, 'f', qubits, dtype,
                               atol).items()
    }
    if initial or final:
        state_inds = [(x,) for x in its.chain(initial, final)]
        arrays.extend(its.chain(initial.values(), final.values()))
        ts_inds.extend(state_inds)
        output_inds = output_inds.difference(
            its.chain.from_iterable(state_inds))

    closed_qubits = OrderedFrozenSet(initial).union(final)
    open_qubits = OrderedFrozenSet(
        its.chain.from_iterable(
            ((q, 'i'), (q, 'f')) for q in qubits)).difference(closed_qubits)

    if decompose_hyper_inds:
        arrays, ts_inds, hyper_inds_map = tn_utils.decompose_hyper_inds(
            arrays, ts_inds, atol=atol)
        output_inds = OrderedFrozenSet(hyper_inds_map[x]
                                       for x in output_inds)

        # Open qubits absorbed into internal labels: invert that mapping so
        # the open label survives (circuit.py:465-478).
        absorbed = {
            y: x
            for x, y in hyper_inds_map.items()
            if x in open_qubits and y not in open_qubits
        }
        hyper_inds_map = {
            x: absorbed.get(y, y) for x, y in hyper_inds_map.items()
        }
        ts_inds = [tuple(absorbed.get(x, x) for x in xs) for xs in ts_inds]

        # Open qubits identified with other open qubits need an explicit
        # Kronecker delta to stay distinct outputs (circuit.py:480-492).
        groups = defaultdict(list)
        for x, y in hyper_inds_map.items():
            if x in open_qubits and y in open_qubits and x != y:
                groups[y].append(x)
        for y, xs in groups.items():
            legs = (y, *xs)
            ts_inds.append(legs)
            arrays.append(_kron_delta(len(legs), dtype))

    output_inds = open_qubits

    if fuse is not None and fuse and fuse > 0:
        path = tn_utils.fuse(ts_inds,
                             2,
                             max_width=fuse,
                             output_inds=output_inds,
                             seed=seed)
        ts_inds, output_inds, arrays = tn_utils.contract(path,
                                                         ts_inds,
                                                         output_inds,
                                                         arrays,
                                                         backend=backend)

    return arrays, ts_inds, frozenset(output_inds)


def cirq_to_gates(circuit, dtype=None):
    """cirq circuit/moment -> [(matrix, qubits)], ignoring measurements.

    Reference: tnco/utils/circuit.py:519-567.
    """
    import cirq

    ops = (circuit.all_operations()
           if hasattr(circuit, 'all_operations') else circuit)
    gates = []
    for op in ops:
        if cirq.is_measurement(op):
            continue
        gates.append((np.asarray(cirq.unitary(op), dtype=dtype), op.qubits))
    return gates


def qiskit_to_gates(circuit, dtype=None):
    """qiskit QuantumCircuit -> [(matrix, qubits)].

    Reference: tnco/utils/circuit.py:572-601.
    """
    import qiskit  # noqa: F401

    gates = []
    for instr in circuit:
        op = instr.operation
        if op.name in ('measure', 'barrier'):
            continue
        matrix = np.asarray(op.to_matrix(), dtype=dtype)
        gates.append((matrix, tuple(instr.qubits)))
    return gates

"""The BGL sampler against a dense statevector (test and smoke helpers).

:func:`recorded_amplitudes` records every amplitude the sampling loop
contracts, with the prefix it belongs to and the bits it projects on;
:func:`visited_probability_error` holds those against the statevector of
the same prefix circuit; :func:`tv_distance` compares sampled frequencies
with the statevector's distribution.
"""

from contextlib import contextmanager

import numpy as np

from tnco_tpu_torch.app.circuit import sampling

__all__ = ['prefix_states', 'recorded_amplitudes',
           'visited_probability_error', 'tv_distance']


def prefix_states(gates, qubits):
    """Statevectors (shape ``(2,) * len(qubits)``, axes in ``qubits``
    order) of ``|0...0>`` after each gate of ``gates``."""
    qubits = list(qubits)
    state = np.zeros((2,) * len(qubits), dtype=complex)
    state[(0,) * len(qubits)] = 1
    out = []
    for matrix, qs in gates:
        axes = [qubits.index(q) for q in qs]
        k = len(axes)
        u = np.asarray(matrix, dtype=complex).reshape((2,) * 2 * k)
        state = np.tensordot(u, state, axes=(range(k, 2 * k), axes))
        rest = [a for a in range(len(qubits)) if a not in axes]
        state = state.transpose(np.argsort(axes + rest))
        out.append(state)
    return out


@contextmanager
def recorded_amplitudes(state):
    """Within the block, every amplitude that ``sample`` contracts on the
    intermediate ``state`` is appended to the yielded list as ``(entry,
    bits, amplitude)``: the index of the circuit operation whose prefix
    network it is, ``{qubit: bit}`` of its projectors, and the complex
    amplitude."""
    records = []
    entries = [(i, e) for i, e in enumerate(state) if e[0] is not None]

    def record(fn):
        def wrapped(*args, arrays=None, **kwargs):
            out = fn(*args, arrays=arrays, **kwargs)
            (i, entry), = ((i, e) for i, e in entries
                           if len(arrays) == len(e[2]) + len(e[3]) and all(
                               a is b for a, b in zip(arrays, e[2])))
            projs = arrays[len(entry[2]):]
            bits = {q: int(np.asarray(p)[1] == 1)
                    for q, p in zip(entry[3], projs)}
            records.append((i, bits, complex(np.asarray(out[2][0]))))
            return out
        return wrapped

    saved = sampling.contract, sampling.contract_sliced
    sampling.contract = record(saved[0])
    sampling.contract_sliced = record(saved[1])
    try:
        yield records
    finally:
        sampling.contract, sampling.contract_sliced = saved


def visited_probability_error(records, gates, qubits):
    """Largest ``| |amplitude|^2 - p |`` over the records, where ``p`` is
    the probability of the recorded bits (0 on the prefix's other qubits)
    in the statevector after the entry's prefix of ``gates``."""
    states = prefix_states(gates, qubits)
    qubits = list(qubits)
    worst = 0.0
    for i, bits, amp in records:
        index = [0] * len(qubits)
        for q, b in bits.items():
            index[qubits.index(q)] = b
        want = abs(states[i][tuple(index)])**2
        worst = max(worst, abs(abs(amp)**2 - want))
    return worst


def tv_distance(hits, qubit_order, gates):
    """Total-variation distance between normalized ``hits`` (bitstrings in
    ``qubit_order``) and the statevector's distribution after ``gates``."""
    probs = np.abs(prefix_states(gates, qubit_order)[-1].reshape(-1))**2
    freq = np.zeros_like(probs)
    total = sum(hits.values())
    for bits, n in hits.items():
        freq[int(bits, 2)] = n / total
    return 0.5 * float(np.abs(freq - probs).sum())

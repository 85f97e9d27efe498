"""Benchmark tensor networks and circuits (the port's copy of
``benchmarks/networks.py:37-207``, plus circuit forms of the Sycamore-like
network).

Each ``*_tn`` builder returns ``(ts_inds, output_inds, dims)``;
:func:`qaoa_circuit`, :func:`qaoa_sampling_circuit` and
:func:`sycamore_circuit` return gate lists
``[(matrix, qubits)]`` and :func:`sycamore_qasm` OPENQASM 2.0 text.  They
are test and smoke inputs.
"""

import math
from random import Random

import numpy as np

__all__ = ['lattice_2d', 'random_regular', 'qaoa_circuit',
           'qaoa_sampling_circuit', 'qaoa_tn',
           'sycamore_like_tn', 'sycamore_circuit', 'sycamore_qasm',
           'hyper_chain_tn']


def lattice_2d(rows: int = 8, cols: int = 8, dim: int = 2):
    """2D square-lattice TN (open boundary)."""
    ts_inds = [[] for _ in range(rows * cols)]
    dims = {}

    def tid(r, c):
        return r * cols + c

    for r in range(rows):
        for c in range(cols):
            if c + 1 < cols:
                x = f'h{r}_{c}'
                ts_inds[tid(r, c)].append(x)
                ts_inds[tid(r, c + 1)].append(x)
                dims[x] = dim
            if r + 1 < rows:
                x = f'v{r}_{c}'
                ts_inds[tid(r, c)].append(x)
                ts_inds[tid(r + 1, c)].append(x)
                dims[x] = dim
    return [tuple(xs) for xs in ts_inds], frozenset(), dims


def random_regular(n_tensors: int = 150, degree: int = 3, dim: int = 2,
                   seed: int = 0):
    """Random d-regular graph TN via configuration model with retries."""
    rng = Random(seed)
    if n_tensors * degree % 2:
        raise ValueError("n * degree must be even.")
    for _ in range(1000):
        stubs = [t for t in range(n_tensors) for _ in range(degree)]
        rng.shuffle(stubs)
        edges = list(zip(stubs[::2], stubs[1::2]))
        if any(a == b for a, b in edges):
            continue
        if len({tuple(sorted(e)) for e in edges}) != len(edges):
            continue
        break
    else:
        raise RuntimeError("Failed to build a simple regular graph.")
    ts_inds = [[] for _ in range(n_tensors)]
    dims = {}
    for i, (a, b) in enumerate(edges):
        x = f'e{i}'
        ts_inds[a].append(x)
        ts_inds[b].append(x)
        dims[x] = dim
    return [tuple(xs) for xs in ts_inds], frozenset(), dims


def _grid_qubits_53():
    """53 qubits on a Sycamore-like diagonal grid."""
    qubits = []
    rows = [6, 6, 6, 6, 6, 6, 6, 6, 5]
    for r, n in enumerate(rows):
        for c in range(n):
            qubits.append((r, c))
    return qubits[:53]


# The coupler patterns' order over the cycles (the published ABCD-CDAB).
_SYCAMORE_ORDER = 'ABCDCDAB'


def _sycamore_patterns():
    """The 53 grid qubits and their couplers in the 4 patterns A-D."""
    qubits = _grid_qubits_53()
    qset = set(qubits)
    patterns = {k: [] for k in 'ABCD'}
    for q in qubits:
        r, c = q
        for i, nb in enumerate([(r + 1, c), (r, c + 1)]):
            if nb in qset:
                if i == 0:  # vertical
                    patterns['A' if (r + c) % 2 == 0 else 'B'].append(
                        (q, nb))
                else:  # horizontal
                    patterns['C' if (r + c) % 2 == 0 else 'D'].append(
                        (q, nb))
    return qubits, patterns


def sycamore_like_tn(m_cycles: int = 20, seed: int = 0):
    """Sycamore-53-like random circuit TN, m cycles of fsim couplers.

    53 qubits on the Sycamore grid, per cycle one of 4 coupler patterns
    (ABCD-CDAB order) + a single-qubit gate per qubit.  Gates become
    rank-2/4 tensors, inputs/outputs are closed with states, so the TN
    scale matches the published networks (m=20: 1621 tensors, 2023
    indices of dim 2).  ``seed`` is kept for API parity (the topology is
    deterministic).
    """
    del seed
    qubits, patterns = _sycamore_patterns()
    ts_inds = []
    dims = {}
    moment = {q: 0 for q in qubits}

    def add_tensor(qs):
        legs = []
        for q in qs:
            legs.append((q, moment[q] + 1))
            legs.append((q, moment[q]))
        for q in qs:
            moment[q] += 1
        ts_inds.append(tuple(legs))
        for leg in legs:
            dims[leg] = 2

    # Initial states: rank-1 tensors on (q, 0)
    for q in qubits:
        ts_inds.append(((q, 0),))
        dims[(q, 0)] = 2

    for cycle in range(m_cycles):
        for q in qubits:
            add_tensor((q,))
        for q, nb in patterns[_SYCAMORE_ORDER[cycle % len(_SYCAMORE_ORDER)]]:
            add_tensor((q, nb))

    # Final states
    for q in qubits:
        ts_inds.append(((q, moment[q]),))

    return [tuple(xs) for xs in ts_inds], frozenset(), dims


def _sycamore_cycles(m_cycles, seed):
    """Per cycle: each qubit's single-qubit gate name ('sx', 'sy' or
    'sw', drawn from ``seed`` and never the qubit's previous one, as in
    the published circuits), then the cycle's couplers."""
    rng = Random(seed)
    qubits, patterns = _sycamore_patterns()
    last = dict.fromkeys(qubits)
    for cycle in range(m_cycles):
        singles = []
        for q in qubits:
            last[q] = rng.choice([g for g in ('sx', 'sy', 'sw')
                                  if g != last[q]])
            singles.append((last[q], q))
        yield singles, patterns[_SYCAMORE_ORDER[cycle %
                                                len(_SYCAMORE_ORDER)]]


def _rot(axis, theta):
    """``exp(-i theta/2 (axis . (X, Y, Z)))`` for a unit ``axis``."""
    nx, ny, nz = axis
    pauli = np.array([[nz, nx - 1j * ny], [nx + 1j * ny, -nz]])
    return (math.cos(theta / 2) * np.eye(2) -
            1j * math.sin(theta / 2) * pauli)


def _fsim(theta, phi):
    # rounded, so that cos(pi/2) is an exact 0 (a permutation with phases)
    c, s = (round(x, 15) for x in (math.cos(theta), math.sin(theta)))
    return np.array([[1, 0, 0, 0], [0, c, -1j * s, 0], [0, -1j * s, c, 0],
                     [0, 0, 0, np.exp(-1j * phi)]])


def sycamore_circuit(m_cycles: int = 20, seed: int = 0):
    """The Sycamore-53 random circuit as a gate list ``[(matrix, qubits)]``.

    The grid and cycles of :func:`sycamore_like_tn`: per cycle a
    single-qubit gate on every qubit, sqrt(X), sqrt(Y) or sqrt(W) with
    W = (X + Y)/sqrt(2) (drawn from ``seed``, never the qubit's previous
    one), then the cycle's couplers as fSim(theta=pi/2, phi=pi/6).  Qubits
    are the grid's ``(row, col)`` tuples.
    """
    one = {'sx': _rot((1, 0, 0), math.pi / 2),
           'sy': _rot((0, 1, 0), math.pi / 2),
           'sw': _rot((1 / math.sqrt(2), 1 / math.sqrt(2), 0), math.pi / 2)}
    fsim = _fsim(math.pi / 2, math.pi / 6)
    gates = []
    for singles, couplers in _sycamore_cycles(m_cycles, seed):
        gates += [(one[g], (q,)) for g, q in singles]
        gates += [(fsim, pair) for pair in couplers]
    return gates


def sycamore_qasm(m_cycles: int = 20, seed: int = 0) -> str:
    """The circuit of :func:`sycamore_circuit` as OPENQASM 2.0 text with
    qelib1 gates: ``cz`` couplers; sqrt(X) as ``sx``, sqrt(Y) as
    ``ry(pi/2)`` and sqrt(W) as ``u3(pi/2,-pi/4,pi/4)`` (no single
    ``rx``/``ry`` is sqrt(W)).  Qubit k is the k-th grid qubit of
    :func:`sycamore_circuit`."""
    qasm = {'sx': 'sx', 'sy': 'ry(pi/2)', 'sw': 'u3(pi/2,-pi/4,pi/4)'}
    index = {q: k for k, q in enumerate(_grid_qubits_53())}
    lines = ['OPENQASM 2.0;', 'include "qelib1.inc";',
             f'qreg q[{len(index)}];']
    for singles, couplers in _sycamore_cycles(m_cycles, seed):
        lines += [f'{qasm[g]} q[{index[q]}];' for g, q in singles]
        lines += [f'cz q[{index[a]}],q[{index[b]}];' for a, b in couplers]
    return '\n'.join(lines) + '\n'


def qaoa_circuit(n_qubits: int = 26, p_layers: int = 4, seed: int = 0):
    """QAOA circuit on a random 3-regular graph: [(matrix, qubits)]."""
    rng = Random(seed)
    if n_qubits * 3 % 2:
        n_qubits += 1
    edges = []
    ts, _, _ = random_regular(n_qubits, 3, 2, seed)
    edge_map = {}
    for t, xs in enumerate(ts):
        for x in xs:
            edge_map.setdefault(x, []).append(t)
    edges = [tuple(v) for v in edge_map.values()]

    h = np.array([[1, 1], [1, -1]]) / math.sqrt(2)
    gates = [(h, (q,)) for q in range(n_qubits)]
    for _ in range(p_layers):
        gamma = rng.uniform(0, math.pi)
        beta = rng.uniform(0, math.pi)
        zz = np.diag([
            np.exp(-0.5j * gamma), np.exp(0.5j * gamma),
            np.exp(0.5j * gamma), np.exp(-0.5j * gamma)
        ])
        for a, b in edges:
            gates.append((zz, (a, b)))
        rx = np.array([[math.cos(beta / 2), -1j * math.sin(beta / 2)],
                       [-1j * math.sin(beta / 2), math.cos(beta / 2)]])
        for q in range(n_qubits):
            gates.append((rx, (q,)))
    return gates


def qaoa_sampling_circuit(n_qubits: int = 26, p_layers: int = 4,
                          seed: int = 0):
    """The circuit of :func:`qaoa_circuit` with each ZZ(gamma) written
    exactly as CX, Rz(gamma) on the second qubit, CX: the form the BGL
    sampler takes.  Its multi-qubit gates must be permutations whose
    entries have modulus exactly 1, which the rounded phases of the
    diagonal ZZ do not have."""
    cx = np.eye(4)[[0, 1, 3, 2]]
    gates = []
    for m, qs in qaoa_circuit(n_qubits, p_layers, seed):
        if len(qs) == 2:
            gates += [(cx, qs), (np.diag(np.diag(m)[:2]), qs[1:]), (cx, qs)]
        else:
            gates.append((m, qs))
    return gates


def qaoa_tn(n_qubits: int = 26, p_layers: int = 4, seed: int = 0):
    """QAOA circuit converted to a TN (no fuse, hyper decomposition on)."""
    from tnco_tpu_torch.utils.circuit import load

    arrays, ts_inds, output_inds = load(qaoa_circuit(n_qubits, p_layers,
                                                     seed),
                                        initial_state='0',
                                        final_state='0',
                                        simplify=False,
                                        decompose_hyper_inds=True,
                                        fuse=3)
    dims = {}
    for a, xs in zip(arrays, ts_inds):
        dims.update(zip(xs, np.asarray(a).shape))
    return [tuple(xs) for xs in ts_inds], frozenset(output_inds), dims


def hyper_chain_tn(n_tensors: int, dim: int = 2):
    """A chain of ``n_tensors`` tensors joined by 3-way hyper-indices:
    index k is shared by tensors 2k, 2k + 1 and 2k + 2, so tensor 2k + 1
    has rank 1.  It has about ``n_tensors / 2`` indices: many nodes on
    few index words (7001 tensors: N = 14001 nodes on W = 110 words),
    which puts the walker's topology beyond one block's shared memory at
    a width the walker admits.  (The port's own builder; the JAX package
    has none.)"""
    ts_inds = [[] for _ in range(n_tensors)]
    dims = {}
    for k in range((n_tensors - 1) // 2):
        x = f'x{k}'
        for t in (2 * k, 2 * k + 1, 2 * k + 2):
            ts_inds[t].append(x)
        dims[x] = dim
    return [tuple(xs) for xs in ts_inds], frozenset(), dims

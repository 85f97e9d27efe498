"""Benchmark tensor networks (the port's copy of
``benchmarks/networks.py:37-59,145-207``).

Each builder returns ``(ts_inds, output_inds, dims)``.
"""

__all__ = ['lattice_2d', 'sycamore_like_tn', 'hyper_chain_tn']


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


def _grid_qubits_53():
    """53 qubits on a Sycamore-like diagonal grid."""
    qubits = []
    rows = [6, 6, 6, 6, 6, 6, 6, 6, 5]
    for r, n in enumerate(rows):
        for c in range(n):
            qubits.append((r, c))
    return qubits[:53]


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
    qubits = _grid_qubits_53()
    qset = set(qubits)

    def neighbors(q):
        r, c = q
        return [(r + 1, c), (r, c + 1)]

    patterns = {k: [] for k in 'ABCD'}
    for q in qubits:
        r, c = q
        for i, nb in enumerate(neighbors(q)):
            if nb in qset:
                if i == 0:  # vertical
                    patterns['A' if (r + c) % 2 == 0 else 'B'].append(
                        (q, nb))
                else:  # horizontal
                    patterns['C' if (r + c) % 2 == 0 else 'D'].append(
                        (q, nb))

    order = 'ABCDCDAB'
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
        for q, nb in patterns[order[cycle % len(order)]]:
            add_tensor((q, nb))

    # Final states
    for q in qubits:
        ts_inds.append(((q, moment[q]),))

    return [tuple(xs) for xs in ts_inds], frozenset(), dims


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

"""The benchmark's networks, generated from their published description.

Each generator returns ``(ts_inds, output_inds, dims)``: one index tuple
per tensor, the open indices, and the dimension of every index.

The Sycamore-53 random circuit (Arute et al., Nature 574, 505 (2019)).
The processor is 54 qubits on a square lattice, each coupled to its
nearest neighbours, given here as the rows of its grid (qubit ``(r, c)``
couples to ``(r + 1, c)`` and ``(r, c + 1)`` where both exist; the
paper draws the same lattice turned by 45 degrees).  One qubit was
inoperable, so the circuit runs on 53 qubits and 86 couplers.  A cycle
is a single-qubit gate on every qubit and then the two-qubit gates of
one of four coupler patterns A-D, in the order ABCDCDAB; after the last
cycle every qubit takes one more single-qubit gate (the half cycle
before measurement).  Patterns: A and B the couplers ``(r, c)-(r + 1,
c)`` with ``r + c`` even and odd; C and D the couplers ``(r, c)-(r, c +
1)`` with ``r + c`` odd and even.  At ``m = 20`` that is 1113
single-qubit and 430 two-qubit gates.

Gates become rank-2 and rank-4 tensors, and every qubit is closed by a
rank-1 state at both ends (an amplitude), so m=20 has 1649 tensors and
2026 indices of dimension 2 (the unfused network).
"""

import itertools

__all__ = ['GENERATORS', 'build', 'index_order', 'sycamore53_couplers',
           'sycamore53_qubits', 'sycamore53_tn']

# The 54-qubit grid, one string a row: a letter is a qubit, '-' none.
_SYCAMORE_GRID = (
    '-----AB---',
    '----ABCD--',
    '---ABCDEF-',
    '--ABCDEFGH',
    '-ABCDEFGHI',
    'ABCDEFGHI-',
    '-CDEFGHI--',
    '--EFGHI---',
    '---GHI----',
    '----I-----',
)
# The inoperable qubit, left out of the circuit.
_INOPERABLE = (2, 3)
# The coupler patterns' order over the cycles.
_ORDER = 'ABCDCDAB'


def sycamore53_qubits() -> list:
    """The 53 qubits ``(row, col)`` of the circuit, row by row."""
    return [(r, c) for r, row in enumerate(_SYCAMORE_GRID)
            for c, ch in enumerate(row)
            if ch != '-' and (r, c) != _INOPERABLE]


def sycamore53_couplers() -> dict:
    """The couplers of each pattern A-D between the 53 qubits."""
    qset = set(sycamore53_qubits())
    patterns = {k: [] for k in 'ABCD'}
    for r, c in sorted(qset):
        odd = (r + c) % 2
        if (r + 1, c) in qset:
            patterns['AB'[odd]].append(((r, c), (r + 1, c)))
        if (r, c + 1) in qset:
            patterns['DC'[odd]].append(((r, c), (r, c + 1)))
    return patterns


def sycamore53_tn(m_cycles: int = 20):
    """The Sycamore-53 network of ``m_cycles`` cycles and the closing
    half cycle (unfused)."""
    qubits = sycamore53_qubits()
    patterns = sycamore53_couplers()
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

    for q in qubits:                      # initial states on (q, 0)
        ts_inds.append(((q, 0),))
        dims[(q, 0)] = 2
    for cycle in range(m_cycles):
        for q in qubits:
            add_tensor((q,))
        for q, nb in patterns[_ORDER[cycle % len(_ORDER)]]:
            add_tensor((q, nb))
    for q in qubits:                      # the half cycle
        add_tensor((q,))
    for q in qubits:                      # final states
        ts_inds.append(((q, moment[q]),))

    return [tuple(xs) for xs in ts_inds], frozenset(), dims


# Generators by the name a configuration file gives under "network".
GENERATORS = {'sycamore53': sycamore53_tn}


def build(network: dict):
    """``(ts_inds, output_inds, dims)`` of a configuration's ``network``
    entry: ``{"generator": <name>, <its keyword arguments>}``."""
    kwargs = dict(network)
    return GENERATORS[kwargs.pop('generator')](**kwargs)


def index_order(ts_inds) -> tuple:
    """Every index once, in order of first appearance: bit ``j`` of an
    index set is ``index_order(ts_inds)[j]``, for the program and the
    reference alike."""
    return tuple(dict.fromkeys(itertools.chain.from_iterable(ts_inds)))

"""The benchmark's networks: generated from their published description,
or frozen into data files.

A configuration's ``"network"`` entry is ``{"generator": <name>, <its
keyword arguments>}`` or ``{"file": <name>}``.  Either gives ``(ts_inds,
output_inds, dims)``: one index tuple per tensor, the open indices, and
the dimension of every index.

A frozen network is ``nets/<name>.json``: ``ts_inds`` (one list of index
ids a tensor), ``output_inds``, ``dims`` (one entry per index id), and
``source`` and ``built_by``, where it came from and the command that
wrote it.  Index ids are ``0, 1, ...`` in order of first appearance, so
the file's own order is :func:`index_order`.  Write one from any function
that returns the triple (a generator here, or the program's own fusion,
:func:`portbench.runners.fused_network`):

    python3 -m portbench.networks write <name> <module:function> \
        '<keyword arguments as JSON>' --source '<where it comes from>'

Once written, the file is the network: a change to the function moves no
cell.

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

import argparse
import importlib
import itertools
import json

from portbench import spec

__all__ = ['GENERATORS', 'build', 'index_order', 'load', 'write', 'freeze',
           'sycamore53_couplers', 'sycamore53_qubits', 'sycamore53_tn']

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
    entry: ``{"generator": <name>, <its keyword arguments>}`` or ``{"file":
    <name>}``."""
    kwargs = dict(network)
    if 'file' in kwargs:
        if len(kwargs) != 1:
            raise ValueError(f'A file entry names the file alone: {network}.')
        return load(spec.net_file(kwargs['file']))
    return GENERATORS[kwargs.pop('generator')](**kwargs)


def load(path):
    """``(ts_inds, output_inds, dims)`` of the frozen network at
    ``path``."""
    data = json.loads(path.read_text())
    dims = {i: int(d) for i, d in enumerate(data['dims'])}
    ts_inds = [tuple(int(x) for x in xs) for xs in data['ts_inds']]
    output_inds = frozenset(int(x) for x in data['output_inds'])
    for x in itertools.chain(output_inds, *ts_inds):
        if x not in dims:
            raise ValueError(f'{path.name}: index {x} has no dimension.')
    return ts_inds, output_inds, dims


def write(path, ts_inds, output_inds, dims, source: str,
          built_by: str) -> None:
    """Writes a network to ``path``, its indices renamed ``0, 1, ...`` in
    order of first appearance."""
    order = index_order(ts_inds)
    ids = {x: i for i, x in enumerate(order)}
    if not set(output_inds) <= set(ids):
        raise ValueError('An open index lies on no tensor.')
    head = json.dumps({
        'source': source, 'built_by': built_by, 'tensors': len(ts_inds),
        'indices': len(order),
        'output_inds': sorted(ids[x] for x in output_inds),
        'dims': [int(dims[x]) for x in order]})
    rows = [json.dumps([ids[x] for x in xs]) for xs in ts_inds]
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(head[:-1] + ', "ts_inds": [\n' + ',\n'.join(rows) +
                    '\n]}\n')


def freeze(name: str, function: str, kwargs: dict, source: str) -> None:
    """Writes ``nets/<name>.json`` from the triple that ``function``
    (``"module:function"``) returns for ``kwargs``."""
    module, _, attr = function.partition(':')
    fn = getattr(importlib.import_module(module), attr)
    built_by = (f'python3 -m portbench.networks write {name} {function} '
                f"'{json.dumps(kwargs, sort_keys=True)}'")
    write(spec.net_file(name), *fn(**kwargs), source=source,
          built_by=built_by)


def index_order(ts_inds) -> tuple:
    """Every index once, in order of first appearance: bit ``j`` of an
    index set is ``index_order(ts_inds)[j]``, for the program and the
    reference alike."""
    return tuple(dict.fromkeys(itertools.chain.from_iterable(ts_inds)))


if __name__ == '__main__':
    ap = argparse.ArgumentParser(prog='portbench.networks')
    ap.add_argument('command', choices=('write',))
    ap.add_argument('name')
    ap.add_argument('function', help='module:function returning (ts_inds, '
                    'output_inds, dims)')
    ap.add_argument('kwargs', help='its keyword arguments, as JSON')
    ap.add_argument('--source', required=True,
                    help='where the network comes from (a paper or URL)')
    args = ap.parse_args()
    freeze(args.name, args.function, json.loads(args.kwargs), args.source)

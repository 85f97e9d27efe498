"""The port's circuit front door against the JAX package's, on the CPU.

The same inputs (seeded numpy gates, QASM text) go through
``tnco_tpu.utils.{qasm,circuit,tn}`` / ``tnco_tpu.app.load_tn`` and their
copies in ``tnco_tpu_torch``.  Both are host numpy with the same
operations in the same order, so arrays are compared bitwise, indices
and output indices for equality.
"""

import functools
import math
import sys
import types

import numpy as np
import pytest

from benchmarks import networks as jnet
from tnco_tpu.app import load_tn as jload_tn
from tnco_tpu.utils import circuit as jcircuit
from tnco_tpu.utils import qasm as jqasm
from tnco_tpu.utils import tensor as jtensor
from tnco_tpu.utils import tn as jtn
from tnco_tpu_torch.app import load_tn as tload_tn
from tnco_tpu_torch.testing import networks as tnet
from tnco_tpu_torch.utils import circuit as tcircuit
from tnco_tpu_torch.utils import qasm as tqasm
from tnco_tpu_torch.utils import tensor as ttensor
from tnco_tpu_torch.utils import tn as ttn
from torch_reference_native import reference_native  # noqa: F401

X = np.array([[0, 1], [1, 0]], dtype=complex)
Y = np.array([[0, -1j], [1j, 0]])
Z = np.diag([1, -1]).astype(complex)
H = np.array([[1, 1], [1, -1]], dtype=complex) / math.sqrt(2)
S = np.diag([1, 1j])
T = np.diag([1, np.exp(1j * np.pi / 4)])
CX = np.eye(4, dtype=complex)[[0, 1, 3, 2]]
CZ = np.diag([1, 1, 1, -1]).astype(complex)
CX_SWAPPED = CX.reshape(2, 2, 2, 2).transpose(1, 0, 3, 2).reshape(4, 4)


def _assert_arrays_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _assert_tn_equal(got, want):
    assert got.ts_inds == want.ts_inds
    assert dict(got.dims) == dict(want.dims)
    assert got.output_inds == want.output_inds
    assert got.sparse_inds == want.sparse_inds
    _assert_arrays_equal(got.arrays, want.arrays)


# --- parse_qasm -----------------------------------------------------------

_PARAMS = {'rx': '(pi/3)', 'ry': '(-0.7)', 'rz': '(2*pi/5)', 'p': '(0.25)',
           'u1': '(-1.5e0)', 'u2': '(pi/4, -pi/8)',
           'u3': '(pi/2, 0, pi)', 'u': '(0.1, 0.2, 0.3)',
           'crz': '(pi*0.5)', 'cp': '(0.3 + pi)', 'cu1': '(2/3)',
           'rzz': '(-pi)'}


@pytest.mark.parametrize('name', sorted(tqasm._FIXED) + sorted(tqasm._PARAM))
def test_parse_qasm_gate_table(name):
    if name in tqasm._FIXED:
        arity = tqasm._FIXED[name][1]
        params = ''
    else:
        arity = tqasm._PARAM[name][1]
        params = _PARAMS[name]
    args = ', '.join(f'q[{k}]' for k in (2, 0, 1)[:arity])
    text = f'OPENQASM 2.0;\nqreg q[3];\n{name}{params} {args};\n'
    got, want = tqasm.parse_qasm(text), jqasm.parse_qasm(text)
    assert len(got) == len(want) == 1
    assert got[0][1] == want[0][1]
    np.testing.assert_array_equal(got[0][0], want[0][0])
    assert got[0][0].shape == (2**arity, 2**arity)


_PROGRAMS = {
    'bell': """
    OPENQASM 2.0;
    include "qelib1.inc";
    qreg q[2];
    creg c[2];
    h q[0];
    cx q[0], q[1];
    measure q[0] -> c[0];
    """,
    'parametrized': """
    OPENQASM 2.0;
    qreg q[1];
    rx(pi/2) q[0];
    u3(pi/2, 0, pi) q[0];
    """,
    'broadcast_and_registers': """
    OPENQASM 2.0;
    // a comment
    qreg a[2];
    qreg b[3];
    h b;
    barrier a, b;
    cz a[1], b[2];
    ccx a[0], a[1], b[0];
    reset a[0];
    """,
}


@pytest.mark.parametrize('name', sorted(_PROGRAMS))
def test_parse_qasm_programs(name):
    got = tqasm.parse_qasm(_PROGRAMS[name])
    want = jqasm.parse_qasm(_PROGRAMS[name])
    assert [qs for _, qs in got] == [qs for _, qs in want]
    _assert_arrays_equal([m for m, _ in got], [m for m, _ in want])


@pytest.mark.parametrize('text,error', [
    ('OPENQASM 2.0; qreg q[1]; foo q[0];', ValueError),
    ('OPENQASM 2.0; qreg q[1]; rx("pi") q[0];', ValueError),
    # names pass the character check; eval has no builtins to reach
    ('OPENQASM 2.0; qreg q[1]; rx(__import__) q[0];', NameError),
    ('OPENQASM 2.0; qreg q[1]; h r;', ValueError),
    ('OPENQASM 2.0; qreg q[2]; cx q[0];', ValueError),
])
def test_parse_qasm_refusals(text, error):
    with pytest.raises(error):
        jqasm.parse_qasm(text)
    with pytest.raises(error):
        tqasm.parse_qasm(text)


# --- commute / same -------------------------------------------------------

_COMMUTE_CASES = [
    ((X, (0,)), (Z, (0,)), {}, False),
    ((X, (0,)), (X, (0,)), {}, True),
    ((X, (0,)), (Z, (1,)), {}, True),
    ((Z, (0,)), (CZ, (0, 1)), {}, True),
    ((X, (0,)), (CZ, (0, 1)), {}, False),
    ((Z, (0,)), (CX, (0, 1)), {}, True),
    ((Z, (1,)), (CX, (0, 1)), {}, False),
    ((Z, (0,)), (CZ, (0, 1)), {'use_matrix_commutation': False}, False),
]


@pytest.mark.parametrize('case', range(len(_COMMUTE_CASES)))
def test_commute(case):
    a, b, kw, expected = _COMMUTE_CASES[case]
    assert jcircuit.commute(a, b, **kw) is expected
    assert tcircuit.commute(a, b, **kw) is expected


_SAME_CASES = [
    ((X, (0,)), (X, (0,)), True),
    ((X, (0,)), (1j * X, (0,)), True),
    ((X, (0,)), (Z, (0,)), False),
    ((X, (0,)), (X, (1,)), False),
    ((CZ, (0, 1)), (CZ, (1, 0)), True),
    ((CX, (0, 1)), (CX_SWAPPED, (1, 0)), True),
]


@pytest.mark.parametrize('case', range(len(_SAME_CASES)))
def test_same(case):
    a, b, expected = _SAME_CASES[case]
    assert jcircuit.same(a, b) is expected
    assert tcircuit.same(a, b) is expected


def test_check_gate_refuses_bad_gates():
    for mod in (jcircuit, tcircuit):
        with pytest.raises(ValueError):
            mod.commute((np.eye(4), (0,)), (X, (0,)))
        with pytest.raises(ValueError):
            mod.same((CZ, (0, 0)), (CZ, (0, 1)))


# --- circuit.load ---------------------------------------------------------

def _random_unitary(rs, n):
    a = rs.normal(size=(n, n)) + 1j * rs.normal(size=(n, n))
    q, r = np.linalg.qr(a)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def random_circuit(seed, n_qubits=4, n_gates=24):
    """Seeded gates on ``n_qubits`` qubits: named 1- and 2-qubit gates,
    random unitaries, and now and then the adjoint of the previous gate
    (which ``simplify`` cancels)."""
    rs = np.random.RandomState(seed)
    ones = [H, X, Y, Z, S, T]
    twos = [CX, CZ, tnet._fsim(math.pi / 2, math.pi / 6)]
    gates = []
    while len(gates) < n_gates:
        kind = rs.randint(6)
        if kind == 5 and gates:
            m, qs = gates[-1]
            gates.append((m.conj().T, qs))
            continue
        if kind < 3:
            q = int(rs.randint(n_qubits))
            m = (ones[rs.randint(len(ones))] if kind < 2 else
                 _random_unitary(rs, 2))
            gates.append((m, (q,)))
        else:
            a, b = (int(x) for x in rs.choice(n_qubits, 2, replace=False))
            m = (twos[rs.randint(len(twos))] if kind == 3 else
                 _random_unitary(rs, 4))
            gates.append((m, (a, b)))
    return gates


_STATES = [('0', '0'), ('0', None), (None, None), ('+', {1: '1', 2: '-'}),
           ({0: np.array([0.6, 0.8])}, '0')]


@pytest.mark.parametrize('simplify', [False, True])
@pytest.mark.parametrize('decompose', [False, True])
@pytest.mark.parametrize('fuse', [False, 3])
@pytest.mark.parametrize('state', range(len(_STATES)))
def test_load_random_circuits(simplify, decompose, fuse, state):
    initial, final = _STATES[state]
    for seed in range(3):
        gates = random_circuit(100 * state + seed)
        kw = dict(initial_state=initial, final_state=final,
                  simplify=simplify, decompose_hyper_inds=decompose,
                  fuse=fuse, seed=seed)
        t_arrays, t_inds, t_out = tcircuit.load(gates, **kw)
        j_arrays, j_inds, j_out = jcircuit.load(gates, **kw)
        assert t_inds == j_inds
        assert t_out == j_out
        _assert_arrays_equal(t_arrays, j_arrays)


def test_load_refusals():
    for mod in (jcircuit, tcircuit):
        with pytest.raises(ValueError):
            mod.load([(H, (0,))], initial_state='x', final_state=None)
        with pytest.raises(ValueError):
            mod.load([(H, (0,))], initial_state={0: np.array([1, 1])})
        with pytest.raises(TypeError):
            mod.load([(H, (0,))], unexpected=1)


def test_load_matches_dense_state():
    """The port's TN contracts to the statevector of the circuit."""
    gates = random_circuit(7, n_qubits=3, n_gates=14)
    arrays, ts_inds, output_inds = tcircuit.load(
        gates, initial_state='0', final_state=None, simplify=False,
        decompose_hyper_inds=True, fuse=False)
    ts_inds, _, (arr,) = ttn.contract([(0, 1)] * (len(ts_inds) - 1),
                                      ts_inds, output_inds, arrays)
    (zs,) = ts_inds
    got = np.asarray(arr).transpose([zs.index((q, 'f'))
                                     for q in range(3)]).reshape(-1)
    state = np.zeros((2,) * 3, dtype=complex)
    state[0, 0, 0] = 1
    for m, qs in gates:
        k = len(qs)
        u = m.reshape((2,) * 2 * k)
        state = np.tensordot(u, state, axes=(range(k, 2 * k), qs))
        rest = [q for q in range(3) if q not in qs]
        state = state.transpose(np.argsort(list(qs) + rest))
    state = state.reshape(-1)
    np.testing.assert_allclose(got, state, atol=1e-12)


# --- cirq / qiskit adapters (fake modules) --------------------------------

class _FakeOp:
    def __init__(self, unitary, qubits, meas=False):
        self._u = unitary
        self.qubits = tuple(qubits)
        self._meas = meas


@pytest.fixture
def fake_cirq(monkeypatch):
    mod = types.ModuleType('cirq')
    mod.is_measurement = lambda op: op._meas
    mod.unitary = lambda op: op._u
    monkeypatch.setitem(sys.modules, 'cirq', mod)
    return mod


def _fake_cirq_circuit(ops):
    cls = type('Circuit', (),
               {'all_operations': lambda self: iter(self._ops)})
    cls.__module__ = 'cirq.circuits.circuit'
    circuit = cls()
    circuit._ops = list(ops)
    return circuit


class _FakeQiskitOp:
    def __init__(self, name, matrix):
        self.name = name
        self._m = matrix

    def to_matrix(self):
        return self._m


class _FakeInstr:
    def __init__(self, op, qubits):
        self.operation = op
        self.qubits = tuple(qubits)


@pytest.fixture
def fake_qiskit(monkeypatch):
    monkeypatch.setitem(sys.modules, 'qiskit', types.ModuleType('qiskit'))


def _fake_qiskit_circuit(instrs):
    cls = type('QuantumCircuit', (),
               {'__iter__': lambda self: iter(self._instrs)})
    cls.__module__ = 'qiskit.circuit.quantumcircuit'
    circuit = cls()
    circuit._instrs = list(instrs)
    return circuit


def test_cirq_adapter(fake_cirq):
    ops = [_FakeOp(H, ('q0',)), _FakeOp(CX, ('q0', 'q1')),
           _FakeOp(np.eye(2), ('q1',), meas=True), _FakeOp(T, ('q1',))]
    circuit = _fake_cirq_circuit(ops)
    got = tcircuit.cirq_to_gates(circuit)
    want = jcircuit.cirq_to_gates(circuit)
    assert [qs for _, qs in got] == [qs for _, qs in want] == [
        ('q0',), ('q0', 'q1'), ('q1',)]
    _assert_arrays_equal([m for m, _ in got], [m for m, _ in want])
    _assert_tn_equal(tload_tn(circuit, fuse=0, seed=3),
                     jload_tn(circuit, fuse=0, seed=3))
    # circuit.load dispatches on the module too
    t = tcircuit.load(circuit, fuse=False)
    j = jcircuit.load(circuit, fuse=False)
    assert t[1] == j[1] and t[2] == j[2]


def test_qiskit_adapter(fake_qiskit):
    instrs = [
        _FakeInstr(_FakeQiskitOp('h', H), (0,)),
        _FakeInstr(_FakeQiskitOp('measure', None), (0,)),
        _FakeInstr(_FakeQiskitOp('barrier', None), (0, 1)),
        _FakeInstr(_FakeQiskitOp('cx', CX), (0, 1)),
    ]
    circuit = _fake_qiskit_circuit(instrs)
    got = tcircuit.qiskit_to_gates(circuit)
    want = jcircuit.qiskit_to_gates(circuit)
    assert [qs for _, qs in got] == [qs for _, qs in want] == [(0,), (0, 1)]
    _assert_arrays_equal([m for m, _ in got], [m for m, _ in want])
    _assert_tn_equal(tload_tn(circuit, fuse=0, seed=3),
                     jload_tn(circuit, fuse=0, seed=3))


# --- load_tn --------------------------------------------------------------

_LOAD_TN_OPTIONS = [dict(), dict(fuse=0), dict(fuse=3, final_state=None),
                    dict(fuse=0, decompose_hyper_inds=False,
                         simplify_circuit=False, initial_state='+')]


@pytest.mark.parametrize('opts', range(len(_LOAD_TN_OPTIONS)))
def test_load_tn_qasm_gates_and_file(opts, tmp_path):
    kw = dict(_LOAD_TN_OPTIONS[opts], seed=5)
    text = tnet.sycamore_qasm(2, seed=opts)
    path = tmp_path / 'circuit.qasm'
    path.write_text(text)
    gates = random_circuit(opts, n_qubits=5, n_gates=30)
    for obj in (text, str(path), gates, tnet.sycamore_circuit(1, opts)):
        _assert_tn_equal(tload_tn(obj, **kw), jload_tn(obj, **kw))


def test_load_tn_cirq_json_needs_cirq(monkeypatch):
    monkeypatch.setitem(sys.modules, 'cirq', None)
    with pytest.raises(ImportError):
        tload_tn({'cirq_type': 'Circuit', 'moments': []})


# --- tensor and tn utilities ----------------------------------------------

def test_get_einsum_subscripts():
    cases = [(['i', 'j'], ['j', 'k'], ['i', 'k']),
             ((('q', 0), 'x'), ('x', 3), ()), ((), (), ())]
    for a, b, out in cases:
        assert (ttensor.get_einsum_subscripts(a, b, out) ==
                jtensor.get_einsum_subscripts(a, b, out))


@pytest.mark.parametrize('left', [(), ('a',), ('c', 'a'), ('a', 'b', 'c')])
def test_svd(left):
    rs = np.random.RandomState(len(left))
    array = rs.normal(size=(2, 3, 4)) + 1j * rs.normal(size=(2, 3, 4))
    array[:, 2] = array[:, 0]          # rank-deficient: one value dropped
    got = ttensor.svd(array, ('a', 'b', 'c'), left, seed=1)
    want = jtensor.svd(array, ('a', 'b', 'c'), left, seed=1)
    assert [x for _, x in got] == [x for _, x in want]
    _assert_arrays_equal([a for a, _ in got], [a for a, _ in want])
    with pytest.raises(ValueError):
        ttensor.svd(array, ('a', 'b', 'c'), ('d',))


@pytest.mark.parametrize('normalize', [False, True])
@pytest.mark.parametrize('ccs', [False, True])
def test_split_contraction_path(normalize, ccs, random_seed):
    rs = np.random.RandomState(random_seed % 2**31)
    for _ in range(4):
        # Three disconnected chains of random lengths.
        ts_inds = []
        for c in range(3):
            n = int(rs.randint(2, 6))
            ts_inds += [((c, k), (c, k + 1)) for k in range(n)]
        order = rs.permutation(len(ts_inds))
        ts_inds = [ts_inds[k] for k in order]
        path = jtn.get_random_contraction_path(
            ts_inds, (), seed=int(rs.randint(2**31)), merge_paths=True)
        got = ttn.split_contraction_path(len(ts_inds), path,
                                         return_connected_components=ccs,
                                         normalize_paths=normalize)
        want = jtn.split_contraction_path(len(ts_inds), path,
                                          return_connected_components=ccs,
                                          normalize_paths=normalize)
        assert got == want


def test_contract_sliced():
    rs = np.random.RandomState(3)
    ts_inds = [('a', 'b'), ('b', 'c', 'x'), ('c', 'd', 'x'), ('d', 'a'),
               ('x', 'e')]
    dims = dict(a=2, b=3, c=2, d=2, x=2, e=3)
    arrays = [rs.normal(size=[dims[x] for x in xs]) for xs in ts_inds]
    path = [(0, 1), (0, 1), (0, 1), (0, 1)]
    for slices, out in (((), ('e',)), (('b',), ('e',)),
                        (('x', 'a'), ('e',)), (('d',), ())):
        got = ttn.contract_sliced(path, ts_inds, slices, out, arrays)
        want = jtn.contract_sliced(path, ts_inds, slices, out, arrays)
        assert got[0] == want[0] and got[1] == want[1]
        _assert_arrays_equal(got[2], want[2])
        full = ttn.contract(path, ts_inds, out, arrays)[2][0]
        np.testing.assert_allclose(got[2][0], full, rtol=1e-12)
    for bad in (dict(slices=('e',), output_inds=('e',)),
                dict(slices=('zz',), output_inds=())):
        with pytest.raises(ValueError):
            ttn.contract_sliced(path, ts_inds, arrays=arrays, **bad)
    with pytest.raises(ValueError):
        ttn.contract_sliced(path[:2], ts_inds, ('b',), ('e',), arrays)


# --- the circuits of the smoke run ----------------------------------------

def test_qaoa_tn_matches_benchmarks(monkeypatch):
    # qaoa_tn fuses with an unseeded path (seed=None) in both packages;
    # seed both fusions alike to compare the networks.
    for mod in (jcircuit, tcircuit):
        monkeypatch.setattr(mod, 'load', functools.partial(mod.load, seed=0))
    got = tnet.qaoa_tn(8, 2, seed=1)
    want = jnet.qaoa_tn(8, 2, seed=1)
    assert got == want
    assert tnet.random_regular(20, 3, seed=4) == jnet.random_regular(
        20, 3, seed=4)
    t_gates, j_gates = tnet.qaoa_circuit(9, 2, 2), jnet.qaoa_circuit(9, 2, 2)
    assert [qs for _, qs in t_gates] == [qs for _, qs in j_gates]
    _assert_arrays_equal([m for m, _ in t_gates], [m for m, _ in j_gates])


def test_sycamore_circuits():
    gates = tnet.sycamore_circuit(4, seed=2)
    parsed = tqasm.parse_qasm(tnet.sycamore_qasm(4, seed=2))
    grid = tnet._grid_qubits_53()
    ts, _, _ = tnet.sycamore_like_tn(4)
    assert len(gates) == len(parsed) == len(ts) - 2 * 53
    last = {}
    for (m, qs), (mq, qq) in zip(gates, parsed):
        assert [('q', grid.index(q)) for q in qs] == list(qq)
        np.testing.assert_allclose(m @ m.conj().T, np.eye(len(m)),
                                   atol=1e-12)
        if len(qs) == 1:
            # the QASM gate is the same rotation, up to a global phase
            assert tcircuit.same((m, (0,)), (mq, (0,)), atol=1e-12)
            assert not tcircuit.same((m, (0,)), (last.get(qs, X), (0,)))
            last[qs] = m
        else:
            np.testing.assert_array_equal(mq, CZ)
            # fSim(pi/2, pi/6): a swap with phases
            assert np.count_nonzero(m) == 4
    assert [len(qs) for _, qs in gates].count(1) == 4 * 53

"""The port's BGL sampler on the CPU: against the JAX sampler on a
carried-across intermediate state, and end to end against a statevector.

The two packages optimize the prefix networks with different random
streams, so their paths differ; the JAX state, carried across by
``convert.sampling_state_from_numpy``, makes the two sampling loops run
on the same paths, and then their hits are identical.
"""

import math
import pickle

import numpy as np
import pytest
import torch

from tnco_tpu.app.circuit import Sampler as JSampler
from tnco_tpu.app.circuit import sample as jsample
from tnco_tpu.app.circuit.sampling import \
    is_classical_operation as j_is_classical
from tnco_tpu_torch.app.circuit import Sampler, sample
from tnco_tpu_torch.app.circuit.sampling import is_classical_operation
from tnco_tpu_torch.convert import sampling_state_from_numpy
from tnco_tpu_torch.testing import sampling as tsampling
from tnco_tpu_torch.testing.networks import qaoa_sampling_circuit
from torch_reference_native import reference_native  # noqa: F401

H = np.array([[1, 1], [1, -1]]) / math.sqrt(2)
X = np.array([[0, 1], [1, 0]])
CX = np.eye(4)[[0, 1, 3, 2]]
OPTIMIZE = dict(betas=(0, 20), n_steps=20, n_runs=1)


@pytest.mark.parametrize('name,matrix,expected', [
    ('x', X, True), ('cx', CX, True), ('ix', 1j * X, True),
    ('h', H, False), ('cz', np.diag([1, 1, 1, -1]), True),
    ('hx', np.kron(H, np.eye(2)), False), ('rect', np.ones((2, 4)), False),
    ('three', np.eye(3), False), ('half', 0.5 * X, False)])
def test_is_classical_operation(name, matrix, expected):
    assert is_classical_operation(matrix) is expected
    assert j_is_classical(matrix) is expected


def _unpack(state):
    """A JAX SamplingIntermediateState as plain tuples and numpy arrays."""
    data = []
    for tn, res, arrays, out_qubits, op_qubits in state:
        if tn is None:
            data.append((None, np.asarray(arrays), op_qubits))
            continue
        slices = getattr(res, 'slices', None)
        data.append((tn.ts_inds, [np.asarray(a) for a in arrays],
                     str(res.cost), res.path,
                     None if slices is None else tuple(slices), out_qubits,
                     op_qubits))
    return data, state.qubits


# Two- and one-qubit gates on 3 qubits: 6 prefix networks to optimize.
T = np.diag([1, np.exp(1j * np.pi / 4)])
CARRIED = [(H, (0,)), (H, (1,)), (CX, (0, 1)), (T, (1,)), (CX, (1, 2)),
           (H, (2,)), (X, (0,)), (H, (1,)), (T, (2,))]


@pytest.fixture(scope='module')
def jax_states():
    """The JAX sampler's intermediate states of CARRIED, without and with
    a width cap (built once: each prefix network costs a JAX compile)."""
    out = {}
    for max_width in (None, 1.0):
        state = JSampler(max_width=max_width, seed=11).sample(
            CARRIED, return_intermediate_state_only=True, **OPTIMIZE)
        if max_width is not None:
            assert any(res is not None and res.slices
                       for _, res, *_ in state)
        out[max_width] = state
    return out


@pytest.mark.parametrize('max_width', [None, 1.0])
@pytest.mark.parametrize('seed', [0, 1, 2])
def test_carried_state_gives_identical_hits(jax_states, max_width, seed):
    jstate = jax_states[max_width]
    tstate = sampling_state_from_numpy(*_unpack(jstate))
    assert len(tstate) == len(jstate) and tstate.qubits == jstate.qubits
    order = (2, 0, 1)
    want = JSampler(max_width=max_width, seed=seed).sample(
        jstate, n_samples=100, qubit_order=order, normalize=False)
    got = Sampler(max_width=max_width, seed=seed, device='cpu').sample(
        tstate, n_samples=100, qubit_order=order, normalize=False)
    assert got == want
    assert len(got[0]) > 1
    # The loop's own entry point, with the torch array backend.
    got = sample(tstate, None, 100, qubit_order=order, normalize=False,
                 seed=seed, contraction_backend='torch')
    want = jsample(jstate, None, 100, qubit_order=order, normalize=False,
                   seed=seed)
    assert got == want


def test_sampler_peaked_deterministic():
    # |q0 q1> = X|0> (x) H H |0> = |1 0>: the sample is the peak, always.
    circuit = [(X, (0,)), (H, (1,)), (H, (1,))]
    sampler = Sampler(seed=5, device='cpu')
    hits, qubits = sampler.sample(circuit, n_samples=20, simplify=False,
                                  fuse=False, decompose_hyper_inds=False,
                                  qubit_order=(0, 1), **OPTIMIZE)
    assert hits == {'10': 1.0}
    assert qubits == (0, 1)


def test_sampler_bell_statistics():
    circuit = [(H, (0,)), (CX, (0, 1))]
    sampler = Sampler(seed=17, device='cpu')
    n = 400
    hits, _ = sampler.sample(circuit, n_samples=n, fuse=False,
                             decompose_hyper_inds=False, simplify=False,
                             qubit_order=(0, 1), normalize=False,
                             **OPTIMIZE)
    assert set(hits) <= {'00', '11'}
    assert sum(hits.values()) == n
    assert abs(hits.get('00', 0) / n - 0.5) < 5 / math.sqrt(n)


def test_sampler_intermediate_state_roundtrip():
    circuit = [(H, (0,)), (X, (1,))]
    sampler = Sampler(seed=3, device='cpu')
    state = sampler.sample(circuit, n_samples=1, fuse=False,
                           simplify=False, decompose_hyper_inds=False,
                           return_intermediate_state_only=True, **OPTIMIZE)
    state2 = pickle.loads(pickle.dumps(state))
    hits, _ = sampler.sample(state2, n_samples=50, qubit_order=(0, 1),
                             **OPTIMIZE)
    assert all(b[1] == '1' for b in hits)
    assert abs(sum(v for b, v in hits.items() if b[0] == '0') - 0.5) < 0.3


def test_sampler_rejects_multiqubit_nonclassical():
    sampler = Sampler(seed=1, device='cpu')
    with pytest.raises(ValueError):
        sampler.sample([(np.kron(H, np.eye(2)), (0, 1))], n_samples=1,
                       **OPTIMIZE)
    with pytest.raises(ValueError):
        sampler.sample([(H, (0,))], n_samples=1, qubit_order=(0, 1),
                       **OPTIMIZE)


def test_sampler_finite_width():
    circuit = [(X, (0,)), (H, (1,)), (H, (1,))]
    sampler = Sampler(max_width=1.0, seed=5, device='cpu')
    state = sampler.sample(circuit, n_samples=1, simplify=False,
                           fuse=False, decompose_hyper_inds=False,
                           return_intermediate_state_only=True, **OPTIMIZE)
    assert any(res is not None and res.slices
               for _, res, *_ in state), 'cap never forced a slice'
    hits, qubits = sampler.sample(state, n_samples=20,
                                  qubit_order=(0, 1), **OPTIMIZE)
    assert hits == {'10': 1.0}
    assert qubits == (0, 1)


def test_sampler_device_rule(monkeypatch):
    """Without CUDA, ``Sampler`` needs ``device='cpu'``; sampling a saved
    state needs no device (no optimizer, host numpy contractions)."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Sampler(seed=0)
    state = Sampler(seed=0, device='cpu').sample(
        [(H, (0,))], return_intermediate_state_only=True, **OPTIMIZE)
    hits, qubits = sample(state, None, 10, normalize=False, seed=0)
    assert qubits == (0,) and sum(hits.values()) == 10
    assert set(hits) <= {'0', '1'}


def test_sampler_against_statevector():
    """4-qubit QAOA, p=2: every probability the loop contracts equals the
    statevector's within 1e-10, and 500 samples are within 0.15 of its
    distribution in total variation (about 0.07 expected)."""
    gates = qaoa_sampling_circuit(4, 2, seed=0)
    order = tuple(range(4))
    sampler = Sampler(seed=3, device='cpu')
    state = sampler.sample(gates, return_intermediate_state_only=True,
                           **OPTIMIZE)
    with tsampling.recorded_amplitudes(state) as records:
        hits, _ = sampler.sample(state, n_samples=500, qubit_order=order)
    assert len(records) == 500 * 2 * sum(e[0] is not None for e in state)
    assert tsampling.visited_probability_error(records, gates, order) < 1e-10
    assert tsampling.tv_distance(hits, order, gates) <= 0.15

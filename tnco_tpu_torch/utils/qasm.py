"""Minimal OPENQASM 2.0 parser -> gate list ``[(matrix, qubits)]`` (the
port's copy of ``tnco_tpu/utils/qasm.py``).

The reference delegates QASM to cirq (tnco/app/app.py:431-436); without
cirq, a small self-contained parser covers the standard ``qelib1`` gate
set (h, x, y, z, s, sdg, t, tdg, sx, rx, ry, rz, p/u1, u2, u3/u, cx, cy,
cz, ch, crz, cp/cu1, swap, ccx, cswap, id; ``measure``/``barrier``/
``creg`` are ignored, matching the reference's measurement handling).
"""

import cmath
import math
import re

import numpy as np

__all__ = ['parse_qasm']

_I = np.eye(2, dtype=complex)
_X = np.array([[0, 1], [1, 0]], dtype=complex)
_Y = np.array([[0, -1j], [1j, 0]], dtype=complex)
_Z = np.array([[1, 0], [0, -1]], dtype=complex)
_H = np.array([[1, 1], [1, -1]], dtype=complex) / math.sqrt(2)
_S = np.diag([1, 1j]).astype(complex)
_T = np.diag([1, cmath.exp(1j * math.pi / 4)])
_SX = 0.5 * np.array([[1 + 1j, 1 - 1j], [1 - 1j, 1 + 1j]], dtype=complex)


def _u3(theta, phi, lam):
    return np.array(
        [[math.cos(theta / 2),
          -cmath.exp(1j * lam) * math.sin(theta / 2)],
         [cmath.exp(1j * phi) * math.sin(theta / 2),
          cmath.exp(1j * (phi + lam)) * math.cos(theta / 2)]],
        dtype=complex)


def _rx(theta):
    return np.array([[math.cos(theta / 2), -1j * math.sin(theta / 2)],
                     [-1j * math.sin(theta / 2),
                      math.cos(theta / 2)]], dtype=complex)


def _ry(theta):
    return np.array([[math.cos(theta / 2), -math.sin(theta / 2)],
                     [math.sin(theta / 2),
                      math.cos(theta / 2)]], dtype=complex)


def _rz(theta):
    return np.diag([cmath.exp(-1j * theta / 2),
                    cmath.exp(1j * theta / 2)])


def _p(lam):
    return np.diag([1, cmath.exp(1j * lam)])


def _controlled(u):
    """2-qubit controlled-U, control = first qubit."""
    out = np.eye(4, dtype=complex)
    out[2:, 2:] = u
    return out


_CX = _controlled(_X)
_SWAP = np.eye(4, dtype=complex)[[0, 2, 1, 3]]


def _ccx():
    out = np.eye(8, dtype=complex)
    out[6:, 6:] = _X
    return out


def _cswap():
    out = np.eye(8, dtype=complex)
    perm = list(range(8))
    perm[5], perm[6] = 6, 5
    return out[perm]


_FIXED = {
    'id': (_I, 1), 'h': (_H, 1), 'x': (_X, 1), 'y': (_Y, 1), 'z': (_Z, 1),
    's': (_S, 1), 'sdg': (_S.conj().T, 1), 't': (_T, 1),
    'tdg': (_T.conj().T, 1), 'sx': (_SX, 1), 'sxdg': (_SX.conj().T, 1),
    'cx': (_CX, 2), 'cnot': (_CX, 2), 'cy': (_controlled(_Y), 2),
    'cz': (_controlled(_Z), 2), 'ch': (_controlled(_H), 2),
    'swap': (_SWAP, 2), 'ccx': (_ccx(), 3), 'toffoli': (_ccx(), 3),
    'cswap': (_cswap(), 3),
}

_PARAM = {
    'rx': (_rx, 1), 'ry': (_ry, 1), 'rz': (_rz, 1), 'p': (_p, 1),
    'u1': (_p, 1),
    'u2': (lambda phi, lam: _u3(math.pi / 2, phi, lam), 1),
    'u3': (_u3, 1), 'u': (_u3, 1),
    'crz': (lambda t: _controlled(_rz(t)), 2),
    'cp': (lambda t: _controlled(_p(t)), 2),
    'cu1': (lambda t: _controlled(_p(t)), 2),
    'rzz': (lambda t: np.diag([
        cmath.exp(-1j * t / 2), cmath.exp(1j * t / 2),
        cmath.exp(1j * t / 2), cmath.exp(-1j * t / 2)]), 2),
}

_SAFE_EVAL = {'pi': math.pi, 'sin': math.sin, 'cos': math.cos,
              'tan': math.tan, 'exp': math.exp, 'ln': math.log,
              'sqrt': math.sqrt}


def _eval_param(expr: str) -> float:
    if not re.fullmatch(r"[\d\s+\-*/().a-z_]*", expr):
        raise ValueError(f"Invalid parameter expression: {expr!r}")
    return float(eval(expr, {'__builtins__': {}}, _SAFE_EVAL))  # noqa: S307


def parse_qasm(text: str):
    """Parses OPENQASM 2.0 into ``[(matrix, (qubit, ...)), ...]``.

    Qubits are ``(register_name, offset)`` tuples.
    """
    # Strip comments, join statements
    text = re.sub(r'//.*', '', text)
    statements = [s.strip() for s in text.split(';') if s.strip()]

    qregs: dict[str, int] = {}
    gates = []

    for stmt in statements:
        low = stmt.lower()
        if (low.startswith('openqasm') or low.startswith('include') or
                low.startswith('creg') or low.startswith('barrier') or
                low.startswith('measure') or low.startswith('reset') or
                low.startswith('if')):
            continue
        m = re.match(r'qreg\s+(\w+)\s*\[\s*(\d+)\s*\]', stmt)
        if m:
            qregs[m.group(1)] = int(m.group(2))
            continue

        m = re.match(r'(\w+)\s*(\(([^)]*)\))?\s*(.+)', stmt)
        if not m:
            raise ValueError(f"Cannot parse QASM statement: {stmt!r}")
        name = m.group(1).lower()
        params = m.group(3)
        args = m.group(4)

        # Resolve qubit arguments
        qubits = []
        for arg in args.split(','):
            arg = arg.strip()
            qm = re.match(r'(\w+)\s*\[\s*(\d+)\s*\]$', arg)
            if qm:
                qubits.append((qm.group(1), int(qm.group(2))))
            elif arg in qregs:
                qubits.append((arg, None))  # whole register (broadcast)
            else:
                raise ValueError(f"Unknown qubit argument: {arg!r}")

        if name in _FIXED:
            matrix, arity = _FIXED[name]
        elif name in _PARAM:
            fn, arity = _PARAM[name]
            values = [_eval_param(p) for p in (params or '').split(',')
                      if p.strip()]
            matrix = fn(*values)
            arity = int(round(math.log2(matrix.shape[0])))
        else:
            raise ValueError(f"Unsupported QASM gate: {name!r}")

        # Broadcast whole-register applications
        if any(off is None for _, off in qubits):
            if len(qubits) != 1:
                raise ValueError(
                    "Register broadcast only supported for 1-qubit gates.")
            reg = qubits[0][0]
            for off in range(qregs[reg]):
                gates.append((matrix, ((reg, off),)))
        else:
            if len(qubits) != arity and name in _FIXED:
                raise ValueError(f"Wrong qubit count for {name!r}.")
            gates.append((matrix, tuple(qubits)))

    return gates

"""The port's CLI (``python -m tnco_tpu_torch.app.cli``) on the CPU,
against the JAX package's CLI where their outputs can agree."""

from decimal import Decimal
import json
import math
import os
from pathlib import Path
import subprocess
import sys

import pytest
import torch

from tnco_tpu.app.cli import main as jmain
from tnco_tpu_torch.app import load_tn
from tnco_tpu_torch.app.cli import main as tmain
from tnco_tpu_torch.ctree import ContractionTree
from tnco_tpu_torch.testing.networks import sycamore_qasm
from torch_reference_native import reference_native  # noqa: F401

_ROOT = Path(__file__).resolve().parents[1]
CHAIN = '[(2, "a", "b"), (2, "b", "c"), (2, "c", "d")]'
BELL = 'OPENQASM 2.0; qreg q[2]; h q[0]; cx q[0], q[1];'


def _lattice_text(n=3):
    rows = []
    for r in range(n):
        for c in range(n):
            if c + 1 < n:
                rows.append(f'2 t{r}{c} t{r}{c + 1}')
            if r + 1 < n:
                rows.append(f'2 t{r}{c} t{r + 1}{c}')
    return '\n'.join(rows)


def test_cli_readme_chain(capsys):
    argv = ['optimize', CHAIN, '--betas=(0, 100)', '--n-steps=50',
            '--n-runs=2', '--seed=3', '--fuse=False']
    assert tmain(argv + ['--device', 'cpu']) == 0
    got = json.loads(capsys.readouterr().out)
    assert jmain(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert int(Decimal(got['res'][0]['cost'])) == 10
    assert [r['cost'] for r in got['res']] == [r['cost'] for r in want['res']]
    assert got['tn'] == want['tn']


def test_cli_finite_width(tmp_path, capsys):
    path = tmp_path / 'lattice.txt'
    path.write_text(_lattice_text())
    argv = ['optimize', str(path), '--betas=(0, 30)', '--n-steps=40',
            '--n-runs=4', '--update_slices=5', '--fuse=False', '--seed=11',
            '--max_width=2']
    assert tmain(argv + ['--device=cpu']) == 0
    got = json.loads(capsys.readouterr().out)
    assert jmain(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert got['tn'] == want['tn']
    assert sorted(got['res'][0]) == sorted(want['res'][0])
    costs = [Decimal(r['cost']) for r in got['res']]
    assert costs == sorted(costs) and len(costs) == 4
    ts_inds = [tuple(t['inds']) for t in got['tn']['tensors']]
    dims = {x: d for t in got['tn']['tensors']
            for x, d in zip(t['inds'], t['dims'])}
    best = got['res'][0]
    tree = ContractionTree([tuple(p) for p in best['path']], ts_inds, dims)
    assert tree.is_valid()
    slices = frozenset(best['slices'])
    assert slices
    for xs in tree.inds:
        assert sum(math.log2(dims[x]) for x in frozenset(xs) - slices) <= 2


def test_cli_sample_bell(capsys):
    argv = ['sample', BELL, '--n-samples=40', '--seed=5', '--fuse=False',
            '--decompose-hyper-inds=False', '--betas=(0, 30)',
            '--n-steps=30']
    assert tmain(argv + ['--device', 'cpu']) == 0
    out = json.loads(capsys.readouterr().out)
    assert out['qubits'] == ["('q', 0)", "('q', 1)"]
    assert set(out['hits']) <= {'00', '11'} and len(out['hits']) == 2
    assert abs(sum(out['hits'].values()) - 1.0) < 1e-9


@pytest.mark.parametrize('initial,final', [('0', '0'), ('+', '1'),
                                            ('0', 'None')])
def test_cli_state_flags(initial, final, capsys):
    """State tokens stay strings ('0' is not the integer 0)."""
    argv = ['optimize', BELL, '--betas=(0, 10)', '--n-steps=5', '--fuse=0',
            '--seed=1', '--device=cpu', f'--initial-state={initial}',
            f'--final-state={final}']
    assert tmain(argv) == 0
    got = json.loads(capsys.readouterr().out)['tn']
    want = json.loads(load_tn(BELL, fuse=0, seed=1, initial_state=initial,
                              final_state=None if final == 'None' else
                              final).to_json())
    assert got == want


def _run(args, hashseed):
    env = dict(os.environ, PYTHONHASHSEED=hashseed)
    return subprocess.run([sys.executable, '-m', 'tnco_tpu_torch.app.cli',
                           *args], capture_output=True, text=True, env=env,
                          cwd=_ROOT, timeout=300)


@pytest.mark.parametrize('what', ['chain', 'qasm', 'sample'])
def test_cli_determinism_across_hashseeds(what, tmp_path):
    """The same JSON under several string hash seeds: ``optimize`` of an
    index map and of a QASM file, and ``sample`` of the Bell circuit,
    whose default qubit order is the circuit's (hash seeds 4, 6 and 7
    put ``('q', 1)`` first when it iterated a frozenset)."""
    hashseeds = ('1', '4242')
    if what == 'chain':
        tn, extra = '2 a b\n2 b c\n2 c d', ['--fuse=False']
    elif what == 'qasm':
        tn = tmp_path / 'syc.qasm'
        tn.write_text(sycamore_qasm(3, seed=1))
        tn, extra = str(tn), ['--max-width=6']
    else:
        hashseeds = ('0', '4', '6', '7')
    outs = []
    for hashseed in hashseeds:
        if what == 'sample':
            args = ['sample', BELL, '--n-samples=40', '--seed=5',
                    '--fuse=False', '--decompose-hyper-inds=False',
                    '--betas=(0, 30)', '--n-steps=30', '--device=cpu']
        else:
            args = ['optimize', tn, '--betas=(0, 30)', '--n-steps=30',
                    '--n-runs=2', '--seed=11', '--device=cpu', *extra]
        proc = _run(args, hashseed)
        assert proc.returncode == 0, proc.stderr
        outs.append(json.loads(proc.stdout))
    for out in outs:
        for r in out.get('res', ()):
            r.pop('runtime_s')
    if what == 'sample':
        assert outs[0]['qubits'] == ["('q', 0)", "('q', 1)"]
    for out in outs[1:]:
        assert out == outs[0]


def test_cli_refuses_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for argv in (['optimize', CHAIN, '--betas=(0, 10)', '--n-steps=5'],
                 ['sample', BELL], ['sample', BELL, '--device', 'cuda']):
        assert tmain(argv) != 0
        err = capsys.readouterr()
        assert "device='cpu'" in err.err and not err.out

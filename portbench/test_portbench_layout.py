"""The benchmark's files: every entry of ``BENCHMARK.json`` resolves to
its files, and nothing the run path loads is JAX or the JAX package
(CPU)."""

import ast
import json
import os
from pathlib import Path
import re
import subprocess
import sys

import pytest

from portbench import harness, spec

BENCH = spec.load()
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')


def test_every_entry_resolves_to_its_files():
    configs = {c['name']: c for c in BENCH['configs']}
    for c in BENCH['configs']:
        path = spec.ROOT / c['file']
        assert path.is_file(), c['file']
        assert json.loads(path.read_text())['name'] == c['name']
    for w in BENCH['workloads']:
        assert w['config'] in configs
        assert spec.traffic_file(w['traffic']).is_file(), w['traffic']
        cell = spec.cell(BENCH, w['name'])
        names = {m['name'] for m in cell['end_to_end']}
        assert 'setup_s' in names and len(names) >= 2
        assert cell['per_layer'], w['name']
    for m in BENCH['end_to_end'] + BENCH['per_layer']:
        assert spec.reader_file(m['name']).is_file(), m['name']
        assert callable(spec.reader(m['name']))


def test_names_and_moves():
    e2e = {m['name'] for m in BENCH['end_to_end']}
    work = {w['name'] for w in BENCH['workloads']}
    for m in BENCH['end_to_end'] + BENCH['per_layer']:
        assert NAME.match(m['name'])
        assert set(m.get('workloads', work)) <= work
    for m in BENCH['per_layer']:
        assert m['moves'] in e2e
        moved = next(x for x in BENCH['end_to_end']
                     if x['name'] == m['moves'])
        assert set(m['workloads']) <= set(moved.get('workloads', work))
    for path in spec.HERE.rglob('*'):
        if '__pycache__' not in path.parts:
            rel = path.relative_to(spec.ROOT).as_posix()
            assert re.match(r'^[A-Za-z0-9_./-]+$', rel), rel


def test_readers_find_nothing_without_a_trace():
    ctx = harness.Context(device_name='cpu', setup_s=1.0, chunk_s=[0.1],
                          window_s=0.1, proposals=10, best_log2=60.0,
                          sizes=(1, 1, 1, 1, 1), config={}, traffic={})
    for m in BENCH['per_layer']:
        assert spec.reader(m['name'])(ctx) is None, m['name']


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module


def test_sources_import_no_jax():
    run_path = [p for p in spec.HERE.rglob('*.py')
                if not p.name.startswith('test_')]
    assert run_path
    for path in run_path:
        for mod in _imports(path):
            assert mod.split('.')[0] not in harness.FORBIDDEN, (path, mod)
            assert not mod.startswith('benchmarks'), (path, mod)


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, 'tnco_tpu_torch_probe', sys)
    assert 'tnco_tpu' not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, 'tnco_tpu.kernels', sys)
    assert harness.forbidden_modules() == ['tnco_tpu']


@pytest.mark.parametrize('workload', ['syc53_im_walker_b1024',
                                      'syc53_fw30_walks_b2048'])
def test_a_run_loads_no_jax(workload):
    code = f"""
import json, sys
from portbench import harness
from test_portbench_faults import tiny
out = harness.execute({workload!r}, 3, 0.2, False, device='cpu',
                      overrides=tiny({workload!r}))
print(json.dumps([out['correct'], harness.forbidden_modules()]))
"""
    res = subprocess.run([sys.executable, '-c', code], cwd=spec.HERE,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=str(spec.ROOT)))
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == [True, []]


def test_the_command_needs_a_card(monkeypatch, capsys):
    import torch

    from portbench import run
    for var in ('TRITON_CACHE_DIR', 'TORCH_EXTENSIONS_DIR',
                'CUDA_CACHE_PATH'):
        monkeypatch.setenv(var, 'unset')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert run.main(['--workload', 'syc53_im_walker_b1024', '--seed', '1',
                     '--seconds', '1', '--trace', '0']) == 2
    assert capsys.readouterr().out == ''

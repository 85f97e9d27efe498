"""The port imports neither ``jax`` nor anything of ``tnco_tpu`` or
``benchmarks``.

In a fresh interpreter where all three are blocked (``sys.modules[name] =
None`` makes any import of them fail), every module of
``tnco_tpu_torch`` and ``chip_smoke.py`` must import.
"""

from pathlib import Path
import subprocess
import sys

_ROOT = Path(__file__).resolve().parents[1]

_SCRIPT = r'''
import importlib, pkgutil, sys
sys.modules['jax'] = None
sys.modules['tnco_tpu'] = None
sys.modules['benchmarks'] = None
import tnco_tpu_torch
names = [m.name for m in pkgutil.walk_packages(tnco_tpu_torch.__path__,
                                               'tnco_tpu_torch.')]
for name in names:
    importlib.import_module(name)
for name in ('tnco_tpu_torch.native', 'tnco_tpu_torch.mesh',
             'tnco_tpu_torch.parallel.dryrun',
             'tnco_tpu_torch.testing.mesh_cases'):
    assert name in names, name
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'tnco_tpu', 'benchmarks')
             and sys.modules[m] is not None)
assert not bad, bad
print(len(names))
'''


def test_port_imports_without_jax_or_tnco_tpu():
    out = subprocess.run([sys.executable, '-c', _SCRIPT], cwd=_ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 20


def test_port_sources_name_no_jax_import():
    for path in (_ROOT / 'tnco_tpu_torch').rglob('*.py'):
        text = path.read_text()
        for bad in ('import jax', 'from jax', 'import tnco_tpu\n',
                    'from tnco_tpu.', 'from tnco_tpu import',
                    'import benchmarks', 'from benchmarks'):
            assert bad not in text, (path, bad)

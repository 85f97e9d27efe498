"""Finds a cell's files by the names in ``BENCHMARK.json``.

- a configuration: the file its entry names (under ``configs/``); its
  ``"network"`` entry names a generator of :mod:`portbench.networks` or a
  frozen network, ``nets/<name>.json`` (``{"file": "<name>"}``);
- a traffic mix: ``traffic/<traffic>.json``; its ``"run_options"`` go
  to every ``run`` call;
- a mix's starting paths: ``starts/<starts>.json``, by the name the mix
  gives under ``"starts"``;
- a metric, end-to-end or per-layer: the reader ``metrics/<name>.py``,
  whose ``read(ctx)`` returns the metric's value, or None where the run
  holds nothing to read.

A later cell, mix or metric is new files and new entries; no file that
exists changes.
"""

import importlib.util
import json
from pathlib import Path

__all__ = ['ROOT', 'HERE', 'load', 'cell', 'applies', 'reader',
           'traffic_file', 'starts_file', 'net_file', 'reader_file']

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(root: Path = ROOT) -> dict:
    return json.loads((root / 'BENCHMARK.json').read_text())


def applies(metric: dict, workload: str) -> bool:
    """Whether a metric entry is reported in ``workload``."""
    return 'workloads' not in metric or workload in metric['workloads']


def traffic_file(name: str) -> Path:
    return HERE / 'traffic' / f'{name}.json'


def starts_file(name: str) -> Path:
    return HERE / 'starts' / f'{name}.json'


def net_file(name: str) -> Path:
    return HERE / 'nets' / f'{name}.json'


def reader_file(name: str) -> Path:
    return HERE / 'metrics' / f'{name}.py'


def reader(name: str):
    """The ``read`` function of metric ``name``."""
    path = reader_file(name)
    spec = importlib.util.spec_from_file_location(
        'portbench_metric_' + name.replace('.', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """A workload's entry, configuration, traffic mix and metric entries:
    ``{'workload', 'config', 'traffic', 'end_to_end', 'per_layer'}``."""
    work = {w['name']: w for w in bench['workloads']}
    if workload not in work:
        raise KeyError(f'No workload {workload!r} in BENCHMARK.json '
                       f'(there are {sorted(work)}).')
    w = work[workload]
    conf = {c['name']: c for c in bench['configs']}[w['config']]
    return {
        'workload': w,
        'config': json.loads((root / conf['file']).read_text()),
        'traffic': json.loads(traffic_file(w['traffic']).read_text()),
        'end_to_end': [m for m in bench['end_to_end']
                       if applies(m, workload)],
        'per_layer': [m for m in bench['per_layer'] if applies(m, workload)],
    }

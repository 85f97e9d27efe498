"""The lower-precision control at each cell's own size, on the card.

Each case runs a cell as the benchmark does (its replicas, its sizes, a
five-second window) and judges the same answers twice: the program's
reported costs, which must pass, and the control's, the reference's own
costs of the program's best trees computed in bfloat16 (the precision
below the float32 the configurations state), which must fail.  Each case
prints both sets of numbers, the readings the limits were set from.  A
second test plants one fault at the cell's size, the best trees left
unrefreshed (:mod:`portbench.test_portbench_faults`), and prints the
numbers it reads.  Run on the card: ``python3 -m pytest portbench -m
cuda -s``.
"""

import json

import pytest

from portbench import harness, spec
from portbench.test_portbench_faults import CELLS, FAULTS

SEEDS = (101, 2**31 + 102, 103)
WORKLOADS = [w['name'] for w in spec.load()['workloads']]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')


@pytest.mark.cuda
@pytest.mark.parametrize('seed', SEEDS)
@pytest.mark.parametrize('workload', WORKLOADS)
def test_control_fails_where_the_program_passes(card, workload, seed):
    out = harness.execute(workload, seed, 5.0, False, control=True)
    print(json.dumps({'workload': workload, 'seed': seed,
                      'program': out['checks'],
                      'control': out['control']['checks']}))
    assert out['correct'], out['checks']
    assert not out['control']['correct'], out['control']


@pytest.mark.cuda
@pytest.mark.parametrize('seed', SEEDS)
@pytest.mark.parametrize('workload', WORKLOADS)
def test_stale_best_fails_at_the_cells_size(card, workload, seed,
                                            monkeypatch):
    mod, name, _ = CELLS[workload]
    real = getattr(mod, name)

    def broken(*a, **k):
        return FAULTS['stale_best'](real, *a, **k)

    monkeypatch.setattr(mod, name, broken)
    out = harness.execute(workload, seed, 5.0, False)
    print(json.dumps({'workload': workload, 'seed': seed,
                      'fault': 'stale_best', 'checks': out['checks']}))
    assert not out['correct'], out['checks']

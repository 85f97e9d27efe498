"""The check sees a broken timed path (CPU).

Each test drives a whole run of a cell without the look for a card, at a
size a CPU holds (Sycamore-53 at 4 cycles, 16 replicas, chunks of 32), on
the engine 'auto' picks on the card, with the engine broken underneath:
a step that returns its state unchanged, half of the replicas left out,
a reported cost altered where it is produced, a tree altered where it is
produced, the best trees and costs left unrefreshed.  ``correct`` must come out false for each, and true without a
fault.  (One chip: no exchange between chips to leave out.)
"""

import pytest
import torch

from portbench import harness
from tnco_tpu_torch.kernels import sa_walks, walker

CELLS = {'syc53_im_walker_b1024': (walker, 'run_walker', 'walker'),
         'syc53_fw30_walks_b2048': (sa_walks, 'run_walks_fw', 'walks')}


def tiny(workload: str) -> dict:
    """Overrides that shrink ``workload`` to a CPU size, on the engine
    that 'auto' picks for it on the card."""
    _, _, engine = CELLS[workload]
    config = {'network': {'generator': 'sycamore53', 'm_cycles': 4},
              'engine': engine, 'chunk_size': 32}
    if 'fw30' in workload:
        config['max_width'] = 12
    return {'config': config,
            'traffic': {'replicas': 16, 'distinct_trees': 4, 'starts': None,
                        'anneal_iterations': 32, 'check_sample': 8,
                        'trace_chunks': 1}}


def _unchanged(real, batch, *a, **k):
    _, metrics = real(batch, *a, **k)
    return batch, metrics


def _half(real, batch, *a, **k):
    out, metrics = real(batch, *a, **k)
    half = batch.c0.shape[1] // 2
    for f in out.field_names():
        if f != 'keys':
            getattr(out, f)[..., half:] = getattr(batch, f)[..., half:]
    return out, metrics


def _cost(real, batch, *a, **k):
    out, metrics = real(batch, *a, **k)
    out.min_log2_total += 0.01
    return out, metrics


def _tree(real, batch, *a, **k):
    out, metrics = real(batch, *a, **k)
    # The root's first child becomes a copy of its second in every best
    # tree.
    root = (out.min_par == -1).to(torch.int64).argmax(dim=0)
    cols = torch.arange(out.min_c0.shape[1])
    out.min_c0[root, cols] = out.min_c1[root, cols]
    return out, metrics


def _stale_best(real, batch, *a, **k):
    out, metrics = real(batch, *a, **k)
    # The best trees and costs are left as they came in.
    for f in out.field_names():
        if f.startswith('min_'):
            getattr(out, f).copy_(getattr(batch, f))
    return out, metrics


FAULTS = {'unchanged': _unchanged, 'half': _half, 'cost': _cost,
          'tree': _tree, 'stale_best': _stale_best}


@pytest.mark.parametrize('workload', sorted(CELLS))
def test_sound_run_is_correct(workload):
    out = harness.execute(workload, 2**31 + 3, 0.3, False, device='cpu',
                          overrides=tiny(workload))
    assert out['correct'], out['checks']
    assert out['engine'] == CELLS[workload][2]


@pytest.mark.parametrize('fault', sorted(FAULTS))
@pytest.mark.parametrize('workload', sorted(CELLS))
def test_broken_engine_is_not_correct(workload, fault, monkeypatch):
    mod, name, _ = CELLS[workload]
    real = getattr(mod, name)

    def broken(*a, **k):
        return FAULTS[fault](real, *a, **k)

    monkeypatch.setattr(mod, name, broken)
    out = harness.execute(workload, 2**31 + 3, 0.3, False, device='cpu',
                          overrides=tiny(workload))
    assert not out['correct'], (fault, out['checks'])
    assert out['failed'] > 0


@pytest.mark.parametrize('workload', sorted(CELLS))
def test_control_is_not_correct(workload):
    out = harness.execute(workload, 2**31 + 3, 0.3, False, device='cpu',
                          overrides=tiny(workload), control=True)
    assert out['correct'], out['checks']
    assert not out['control']['correct'], out['control']

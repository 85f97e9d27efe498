"""The port's support modules: the host fan-out (``parallel.host``:
``Parallel``, ``Buffer``; the counterparts of
``tests/test_parallel.py:17-43``), checkpoints (``parallel.checkpoint``:
a runner resumed from one continues bitwise, the counterpart of
``tests/test_native.py:98-120``; a JAX checkpoint loads field for field;
finite-width and 'vmapped' runners refuse), ``utils.profiling`` and
``utils.compile_cache`` on a host without ``nvcc``.
"""

import json
import time

import numpy as np
import pytest
import torch

from benchmarks.networks import lattice_2d
from tnco_tpu_torch.convert import batch_to_numpy
from tnco_tpu_torch.ctree import ContractionTree
from tnco_tpu_torch.kernels import build
from tnco_tpu_torch.optimize.finite_width import SimpleCostModel as FWModel
from tnco_tpu_torch.parallel import (Buffer, Parallel, ReplicaRunner,
                                     ReplicaRunnerFW)
from tnco_tpu_torch.parallel.checkpoint import (load_batch, load_runner,
                                                save_batch, save_runner)
from tnco_tpu_torch.utils import compile_cache
from tnco_tpu_torch.utils.profiling import ThroughputCounter, trace
from tnco_tpu_torch.utils.tn import get_random_contraction_path
from torch_reference_native import reference_native  # noqa: F401


def test_host_parallel_basic():
    def core(seed, *, idx, status, stop, metric):
        status[idx] = 1.0
        metric[idx] = seed * 2.0
        return seed + 100

    out = Parallel(core, seed=[1, 2, 3], n_jobs=2,
                   buffers=[('metric', 'f')])
    assert out == [101, 102, 103]


def test_host_parallel_timeout_stop():
    def core(seed, *, idx, status, stop):
        n = 0
        while not stop[idx] and n < 500:
            time.sleep(0.01)
            n += 1
        return n

    t0 = time.perf_counter()
    out = Parallel(core, seed=[0, 1], n_jobs=2, timeout=0.2)
    assert time.perf_counter() - t0 < 3.0
    assert all(n < 500 for n in out)
    with pytest.raises(ValueError):
        Parallel(core, seed=[0], n_jobs=0)


def test_buffer_formats():
    b = Buffer(3, 'i')
    b[1] = 7
    assert b[1] == 7 and isinstance(b[1], int) and len(b) == 3
    assert list(b) == [0, 7, 0] and b.data.dtype == np.int32
    assert Buffer(2, '?').data.dtype == np.bool_
    with pytest.raises(ValueError):
        Buffer(2, 'x')


def _trees(n=4, rows=3, cols=4):
    ts, out, dims = lattice_2d(rows, cols)
    return [ContractionTree(get_random_contraction_path(ts, out, seed=s), ts,
                            dims, output_inds=out) for s in range(n)]


def _runner(ctrees, engine):
    return ReplicaRunner(ctrees, list(range(len(ctrees))), engine=engine,
                         device='cpu')


@pytest.mark.parametrize('engine', ['batched', 'walks', 'sweep'])
def test_checkpoint_roundtrip(tmp_path, engine):
    """Save after a run, load into a fresh runner: the same state and
    counters, and the resumed runs continue bitwise (the generator's
    state travels with the checkpoint)."""
    ctrees = [_trees(1)[0]] * 4
    runner = _runner(ctrees, engine)
    runner.run(np.linspace(0, 10, 12), chunk_size=6)
    p = tmp_path / 'ckpt.npz'
    save_runner(p, runner)

    runner2 = _runner(ctrees, engine)
    load_runner(p, runner2)
    assert runner2.sweeps_done == runner.sweeps_done
    assert runner2.moves_done == runner.moves_done
    assert runner2.applied_done == runner.applied_done
    assert torch.equal(runner2._mw_pos, runner._mw_pos)
    a, b = batch_to_numpy(runner.states), batch_to_numpy(runner2.states)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    m1 = runner.run(np.linspace(10, 20, 12), chunk_size=6)
    m2 = runner2.run(np.linspace(10, 20, 12), chunk_size=6)
    np.testing.assert_array_equal(m1['log2_min_total'], m2['log2_min_total'])
    a, b = batch_to_numpy(runner.states), batch_to_numpy(runner2.states)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_checkpoint_loads_jax_npz(tmp_path):
    """A JAX 'batched' runner's checkpoint: ``load_batch`` gives its batch
    field for field (uint32 words as int32 bit patterns), and
    ``load_runner`` takes it into the port's runner."""
    from tnco_tpu.ctree import ContractionTree as JTree
    from tnco_tpu.parallel import ReplicaRunner as JRunner
    from tnco_tpu.parallel.checkpoint import save_runner as jsave

    ts, out, dims = lattice_2d(3, 4)
    paths = [get_random_contraction_path(ts, out, seed=s) for s in range(4)]
    jr = JRunner([JTree(p, ts, dims, output_inds=out) for p in paths],
                 list(range(4)), engine='batched')
    jr.run(np.linspace(0, 5, 8), chunk_size=8)
    p = tmp_path / 'jax.npz'
    jsave(p, jr)
    batch, extra = load_batch(p, 'cpu')
    got = batch_to_numpy(batch)
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(getattr(jr.states,
                                                                 k)),
                                      err_msg=k)
    assert int(extra['sweeps_done']) == jr.sweeps_done
    tr = _runner([ContractionTree(q, ts, dims, output_inds=out)
                  for q in paths], 'batched')
    load_runner(p, tr)
    assert tr.sweeps_done == jr.sweeps_done
    np.testing.assert_array_equal(tr.log2_min_totals(),
                                  np.asarray(jr.states.min_log2_total))
    tr.run(np.linspace(5, 8, 4), chunk_size=4)


def test_checkpoint_refusals(tmp_path):
    """Runners whose state is not an SABatch (finite width, 'vmapped')
    refuse with a ValueError naming the engine; so does a generator
    state of another device type, and a shape that differs."""
    ctrees = _trees(2)
    fw = ReplicaRunnerFW(ctrees, [0, 1], cmodel=FWModel(max_width=3),
                         engine='batched', device='cpu')
    with pytest.raises(ValueError, match="engine='batched'.*SABatchFW"):
        save_runner(tmp_path / 'fw.npz', fw)
    vm = _runner(ctrees, 'vmapped')
    with pytest.raises(ValueError, match="engine='vmapped'.*SAStateIM"):
        save_runner(tmp_path / 'vm.npz', vm)
    im = _runner(ctrees, 'batched')
    p = tmp_path / 'im.npz'
    save_runner(p, im)
    with pytest.raises(ValueError, match="engine='vmapped'"):
        load_runner(p, vm)
    data = dict(np.load(p))
    data['extra_generator_device'] = np.asarray('cuda')
    np.savez(tmp_path / 'card.npz', **data)
    with pytest.raises(ValueError, match="'cuda'.*'cpu'"):
        load_runner(tmp_path / 'card.npz', im)
    save_batch(tmp_path / 'small.npz', _runner(_trees(2, 2, 3),
                                               'batched').states)
    with pytest.raises(ValueError, match='shape'):
        load_runner(tmp_path / 'small.npz', im)


def test_throughput_counter():
    c = ThroughputCounter()
    c.add(100, sweeps=2)
    c.add(50.0)
    rep = c.report()
    assert rep['moves'] == 150 and rep['sweeps'] == 2
    assert rep['runtime_s'] > 0 and rep['moves_per_sec'] > 0


def test_trace(tmp_path):
    """``trace(None)`` does nothing; ``trace(dir)`` writes a Chrome trace
    of what ran inside."""
    with trace(None):
        pass
    with trace(tmp_path / 'prof'):
        torch.ones(64).cumsum(0)
    events = json.loads((tmp_path / 'prof' / 'trace.json').read_text())
    assert events['traceEvents']


def test_compile_cache_enable_and_probe(monkeypatch):
    """``enable`` names the kernel build directory, or None when switched
    off; ``probe`` reads file times and never builds (no ``nvcc``
    here); the CLI calls ``enable`` first, as the JAX CLI does."""
    lib = build.BUILD_DIR / build._LIB_NAME
    existed = lib.is_file()
    monkeypatch.delenv('TNCO_TPU_COMPILE_CACHE', raising=False)
    assert compile_cache.enable() == str(build.BUILD_DIR)
    for off in ('0', 'off', 'None', 'disabled'):
        assert compile_cache.enable(off) is None
        monkeypatch.setenv('TNCO_TPU_COMPILE_CACHE', off)
        assert compile_cache.enable() is None
    rep = compile_cache.probe()
    assert rep == {'enabled': False, 'cache_dir': str(build.BUILD_DIR),
                   'built': existed, 'up_to_date': rep['up_to_date']}
    assert lib.is_file() == existed
    if not existed:
        assert not rep['up_to_date']

    from tnco_tpu_torch.app import cli
    calls = []
    monkeypatch.setattr(compile_cache, 'enable',
                        lambda *a: calls.append(a))
    with pytest.raises(SystemExit):
        cli.main(['--help'])
    assert calls == [()]

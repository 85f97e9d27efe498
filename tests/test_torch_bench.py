"""The port's bench entry point (``tnco_tpu_torch.bench``) vs ``bench.py``.

The set-up is compared with the JAX bench's own (bench.py:43-70: the 8x8
lattice, random paths of seeds 0..63 reused as replica r % 64, ``sb.
init_batch``) at the CPU size, B=32, bitwise.  The engine the bench times
is compared one P=16 iteration at a time with the JAX ``run_multiwalk``
on that batch, the JAX draws injected through ``draws=``: positions,
counters and every state field bitwise, totals within 1e-5 in log2 (the
exp2/log2 gap between XLA and torch, PERF.md "Float bound").  The line
``main(device='cpu')`` prints, the device rule, and the identity check's
comparison helpers are checked on the CPU; the identity check itself
needs the card (``-m cuda``).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from benchmarks.networks import lattice_2d as jlattice_2d
from tnco_tpu.ctree import ContractionTree
from tnco_tpu.kernels import sa_batched as jsb
from tnco_tpu.kernels import sa_multiwalk as jsmw
from tnco_tpu.kernels.sa_fullsweep import uniform_log2_dim
from tnco_tpu.kernels.sa_infinite import SweepConfig
from tnco_tpu.ops import bitops as jbit
from tnco_tpu.utils.tn import get_random_contraction_path
from tnco_tpu_torch import bench
from tnco_tpu_torch.convert import batch_from_numpy, batch_to_numpy
from tnco_tpu_torch.kernels import sa_multiwalk as tsmw
from tnco_tpu_torch.testing.utils import (assert_batches_identical,
                                          assert_tensors_identical)
from torch_reference_native import reference_native  # noqa: F401

TOTAL_ATOL = 1e-5
_TOTALS = ('log2_total', 'min_log2_total')
CPU = torch.device('cpu')


@pytest.fixture(scope='module')
def jax_setup():
    """bench.py's set-up at its CPU size (B=32)."""
    ts_inds, output_inds, dims = jlattice_2d(8, 8)
    order = tuple(dict.fromkeys(x for xs in ts_inds for x in xs))
    n_replicas, _ = bench.sizes(CPU)
    n_paths = min(n_replicas, 64)
    trees = [ContractionTree(
        get_random_contraction_path(ts_inds, output_inds, seed=r), ts_inds,
        dims, output_inds=output_inds, check_shared_inds=True,
        inds_order=order) for r in range(n_paths)]
    ctrees = [trees[r % n_paths] for r in range(n_replicas)]
    t = ctrees[0]
    n_lanes = t.inds_array.shape[1]
    cfg = SweepConfig(n_leaves=t.n_leaves, n_lanes=n_lanes)
    log2d = np.asarray(jbit.pad_log2_dims(t.log2_dims_array, n_lanes))
    batch = jsb.init_batch(ctrees, list(range(n_replicas)), log2d)
    return batch, cfg, log2d, uniform_log2_dim(t.log2_dims_array)


@pytest.fixture(scope='module')
def port_setup():
    return bench.setup(bench.sizes(CPU)[0], CPU)


def _fields(batch):
    return {k: np.asarray(getattr(batch, k)) for k in batch.__slots__}


def test_setup_matches_jax_bench(jax_setup, port_setup):
    jbatch, cfg, log2d, ul = jax_setup
    ctrees, batch, tcfg, tlog2d, tlog2d_w32, tul = port_setup
    assert bench.sizes(CPU) == (32, 32)
    assert len(ctrees) == 32 and (tcfg.n_leaves, tcfg.n_lanes) == (
        cfg.n_leaves, cfg.n_lanes)
    np.testing.assert_array_equal(tlog2d.view(np.uint32),
                                  log2d.view(np.uint32))
    assert tlog2d_w32.shape == (cfg.n_lanes, 32)
    assert tul == ul == 1.0
    got = batch_to_numpy(batch)
    for k, v in _fields(jbatch).items():
        np.testing.assert_array_equal(got[k].view(np.uint32),
                                      v.view(np.uint32), err_msg=k)


def _jax_draws(keys, cfg, p):
    """One iteration of ``run_multiwalk``'s draws, ``[1, P, B]``."""
    _, leaf, rand_bit, u, _ = jsmw._draws(keys, cfg.n_leaves, p,
                                          jnp.float32, 4)
    return {name: torch.from_numpy(np.array(x))[None] for name, x in
            (('leaf', leaf), ('rand_bit', rand_bit), ('u', u))}


def test_engine_iterations_match_jax(jax_setup, port_setup):
    """Two P=16 iterations of the engine the bench times, at two of its
    betas, each from the JAX state with the JAX draws."""
    batch, cfg, log2d, ul = jax_setup
    _, _, tcfg, _, tlog2d_w32, tul = port_setup
    p, b = bench.N_WALKS, batch.c0.shape[1]
    log2d_w32 = jnp.asarray(log2d).reshape(cfg.n_lanes, 32)
    betas = np.linspace(0.0, 30.0, bench.sizes(CPU)[1], dtype=np.float32)
    pos = jnp.full((p, b), -1, jnp.int32)
    applied = 0
    for beta in (betas[0], betas[16]):
        draws = _jax_draws(batch.keys, cfg, p)
        start = batch_from_numpy(_fields(batch), 'cpu')
        ref, mref = jsmw.run_multiwalk(batch, jnp.asarray([beta]), log2d_w32,
                                       cfg, p, pos, uniform_log2=ul)
        got, mgot = tsmw.run_multiwalk(start, torch.tensor([beta]),
                                       tlog2d_w32, tcfg, p,
                                       torch.from_numpy(np.array(pos)),
                                       uniform_log2=tul, draws=draws)
        g = batch_to_numpy(got)
        for k, v in _fields(ref).items():
            if k == 'keys':
                continue
            if k in _TOTALS:
                np.testing.assert_allclose(g[k], v, rtol=0, atol=TOTAL_ATOL,
                                           err_msg=f'beta {beta}: {k}')
            else:
                np.testing.assert_array_equal(g[k], v,
                                              err_msg=f'beta {beta}: {k}')
        np.testing.assert_array_equal(mgot['pos'].numpy(),
                                      np.asarray(mref['pos']))
        assert mgot['moves'] == int(mref['moves']) == p * b
        assert int(mgot['applied']) == int(mref['applied'])
        applied += int(mref['applied'])
        batch, pos = ref, mref['pos']
    assert applied > 0


def test_main_on_cpu_prints_one_line(capsys):
    out = bench.main(device='cpu')
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == out
    assert set(out) == {'metric', 'value', 'unit', 'applied_moves_per_sec',
                        'applied_fraction', 'config', 'device'}
    assert out['metric'] == 'sa_moves_per_sec_per_chip'
    assert out['unit'] == 'moves/s'
    assert out['device'] == {'name': 'cpu'}
    assert out['config'] == {'network': '8x8 lattice, bond dim 2',
                             'replicas': 32, 'walks': 16, 'iterations': 32}
    assert out['value'] > 0 and 0 < out['applied_fraction'] <= 1
    assert out['applied_moves_per_sec'] == pytest.approx(
        out['value'] * out['applied_fraction'])
    assert 'vs_baseline' not in out and 'vs_prev_round' not in out


def test_main_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main()


def test_identity_helpers_flag_one_word(port_setup):
    _, batch, _, _, _, _ = port_setup
    x = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    y = x.clone()
    assert bench._first_difference(
        [('x', assert_tensors_identical, x, y)]) == 'ok'
    y[1, 2] ^= 1
    msg = bench._first_difference([
        ('same', assert_tensors_identical, x, x.clone()),
        ('one word', assert_tensors_identical, x, y)])
    assert msg.startswith('FAIL: one word: ')
    # floats compare as words: another NaN payload is a difference
    f = torch.tensor([float('nan'), 0.0])
    g = f.clone()
    g.view(torch.int32)[0] += 1
    assert bench._first_difference(
        [('nan', assert_tensors_identical, f, g)]).startswith('FAIL: nan')
    assert bench._first_difference(
        [('-0', assert_tensors_identical, f, -f)]).startswith('FAIL: -0')

    assert_batches_identical(batch, batch_from_numpy(batch_to_numpy(batch),
                                                     'cpu'))
    fields = batch_to_numpy(batch)
    fields['inds'] = fields['inds'].copy()
    fields['inds'][3, 0, 5] ^= 1 << 7
    with pytest.raises(AssertionError, match='inds'):
        assert_batches_identical(batch, batch_from_numpy(fields, 'cpu'))
    # totals: 1 ulp passes, 1e-3 does not
    fields = batch_to_numpy(batch)
    fields['min_log2_total'] = np.nextafter(fields['min_log2_total'],
                                            np.float32(np.inf))
    assert_batches_identical(batch, batch_from_numpy(fields, 'cpu'))
    fields['min_log2_total'] = fields['min_log2_total'] + np.float32(1e-3)
    with pytest.raises(AssertionError, match='min_log2_total'):
        assert_batches_identical(batch, batch_from_numpy(fields, 'cpu'))


@pytest.mark.cuda
def test_kernel_identity_check_on_card(port_setup):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the CUDA kernels have no CPU '
                    'mode); run python3 chip_smoke.py on the card')
    ctrees, _, cfg, log2d, log2d_w32, _ = port_setup
    dev = torch.device('cuda')
    assert bench._kernel_identity_check(ctrees[:8], log2d,
                                        log2d_w32.to(dev), cfg, dev) == 'ok'

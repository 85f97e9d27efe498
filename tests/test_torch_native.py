"""The port's native host core (``tnco_tpu_torch.native``) and its
'native' runner engine against the JAX package's, on the same inputs:
validation, exact costs, the CPU SA engines, the runners, 'auto' routing
with native on in both packages, and the validator fast path of
``ContractionTree.is_valid``.  The engine calls pass ``n_threads`` <= 2
(xdist runs several workers; the results do not depend on it); the
runners use every core, as the JAX runners do, one thread a replica at
most.  The JAX side loads a private build of its library
(``torch_reference_native``), never the shared file that its workers
build in place at once."""

import json
import math
from pathlib import Path
from random import Random

import numpy as np
import pytest

from benchmarks.networks import lattice_2d
from tnco_tpu import native as jnative
from tnco_tpu.app import app as japp
from tnco_tpu.app.tn import Tensor as JT, TensorNetwork as JTN
from tnco_tpu.ctree import ContractionTree
from tnco_tpu.kernels import sa_finite as jsaf
from tnco_tpu.ops import bitops as jbitops
from tnco_tpu.optimize.finite_width import SimpleCostModel as JFWModel
from tnco_tpu.optimize.infinite_memory import SimpleCostModel as JIMModel
from tnco_tpu.parallel import replicas as jrep
from tnco_tpu.testing.utils import generate_random_tensors
from tnco_tpu.utils.tn import get_random_contraction_path
from tnco_tpu_torch import native
from tnco_tpu_torch.app import app as tapp
from tnco_tpu_torch.app.cli import main as tmain
from tnco_tpu_torch.app.tn import Tensor as TT, TensorNetwork as TTN
from tnco_tpu_torch.ctree import ContractionTree as TContractionTree
from tnco_tpu_torch.optimize.finite_width import SimpleCostModel as TFWModel
from tnco_tpu_torch.optimize.infinite_memory import \
    SimpleCostModel as TIMModel
from tnco_tpu_torch.parallel import replicas as trep
from tnco_tpu_torch.parallel.checkpoint import save_runner
from torch_reference_native import (BUILD_TARGETS, SHARED_LIB,
                                    reference_native)  # noqa: F401


def _pair(rng, random_seed, **kwargs):
    """The same random tree in both packages."""
    ts, out, dims = generate_random_tensors(rng, n_output_inds=2, **kwargs)
    paths = get_random_contraction_path(ts, out, merge_paths=False,
                                        seed=random_seed)
    (path,) = [p for p in paths if p]
    kw = dict(output_inds=out, check_shared_inds=True)
    return ContractionTree(path, ts, dims, **kw), \
        TContractionTree(path, ts, dims, **kw)


def _lattice_pairs(rows, cols, n, seed=0):
    ts, out, dims = lattice_2d(rows, cols)
    paths = [get_random_contraction_path(ts, out, seed=seed + i)
             for i in range(n)]
    return ([ContractionTree(p, ts, dims, output_inds=out) for p in paths],
            [TContractionTree(p, ts, dims, output_inds=out) for p in paths])


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


def _corruptions(t):
    """(name, nodes, inds) arrays that break each rule of the validator,
    from the valid tree ``t``; plus the tree itself."""
    nodes, inds = t.nodes_array, t.inds_array
    n = len(nodes)
    out = [('valid', nodes, inds)]
    bad = nodes.copy()
    bad[-1, 0] = n + 3
    out.append(('range', bad, inds))
    bad = nodes.copy()
    bad[-1, 2] = 0
    out.append(('root', bad, inds))
    bad = nodes.copy()
    bad[0, 2] = -1
    out.append(('two roots', bad, inds))
    bad = nodes.copy()
    internal = np.flatnonzero(nodes[:, 0] >= 0)
    bad[0, 2] = [i for i in internal if i != nodes[0, 2]][0]
    out.append(('parent', bad, inds))
    bad_inds = inds.copy()
    bad_inds[-1, 0] ^= np.uint32(1)
    out.append(('contraction', nodes, bad_inds))
    bad_inds = inds.copy()
    bad_inds[0, 0] ^= np.uint32(1 << 31)
    out.append(('leaf inds', nodes, bad_inds))
    w = inds.shape[1]
    # An internal node before the leaves; and one node too many.
    out.append(('leaves first',
                np.array([[1, 2, 4], [-1, -1, 0], [-1, -1, 0], [-1, -1, 4],
                          [0, 3, -1]], np.int32), np.zeros((5, w), np.uint32)))
    out.append(('count',
                np.array([[-1, -1, 2], [-1, -1, 2], [0, 1, 3], [2, 0, -1]],
                         np.int32), np.zeros((4, w), np.uint32)))
    return out


@pytest.mark.parametrize('rep', range(3))
def test_validate_matches_jax_and_numpy(rep, rng, random_seed):
    """Every corruption gives one ``(ok, message)`` from the port's native
    validator, the JAX package's, and the port's numpy code (the plain
    version), which is also what ``is_valid`` returns."""
    jt, tt = _pair(rng, random_seed + rep)
    seen = set()
    for name, nodes, inds in _corruptions(tt):
        for csi in (False, True):
            got = native.validate(nodes, inds, csi)
            want = jnative.validate(nodes, inds, csi)
            assert got == want, (name, csi)
            t = tt.replace_arrays(nodes, inds)
            assert t._is_valid_numpy(csi) == got, (name, csi)
            assert t.is_valid(csi, return_message=True) == got
            seen.add(got[1])
    assert seen >= {'', 'Nodes are not valid', 'Last node should be root.',
                    'There should be only one root.',
                    'All leaves should be first.',
                    'Number of nodes is not consistent with the number of '
                    'leaves.', 'Tree is not valid.',
                    'Contraction is not valid.'}


@pytest.mark.parametrize('rep', range(3))
def test_total_cost_matches_jax(rep, rng, random_seed):
    jt, tt = _pair(rng, random_seed + rep)
    got = native.total_cost(tt.nodes_array, tt.inds_array, tt.dims_array)
    assert got == jnative.total_cost(jt.nodes_array, jt.inds_array,
                                     jt.dims_array)
    assert int(got[0]) == tt.total_cost_exact()


def test_total_cost_huge():
    """A cost far beyond float64 (``tests/test_native.py:55``): a star
    contraction of two tensors with 40 indices of dim 64, cost 2^240."""
    labels = [f'x{i}' for i in range(40)]
    ts = [tuple(labels), tuple(labels[:20]), tuple(labels[20:])]
    dims = {x: 64 for x in labels}
    tt = TContractionTree([(1, 2), (0, 1)], ts, dims, output_inds=())
    jt = ContractionTree([(1, 2), (0, 1)], ts, dims, output_inds=())
    got = native.total_cost(tt.nodes_array, tt.inds_array, tt.dims_array)
    assert got == jnative.total_cost(jt.nodes_array, jt.inds_array,
                                     jt.dims_array)
    assert int(got[0]) == tt.total_cost_exact()
    assert got[1] == pytest.approx(math.log2(tt.total_cost_exact()),
                                   rel=1e-12)


def _stack(t, r):
    return (np.stack([t.nodes_array.copy() for _ in range(r)]),
            np.stack([t.inds_array.copy() for _ in range(r)]))


@pytest.mark.parametrize('return_final', [False, True])
def test_sa_run_matches_jax(rng, random_seed, return_final):
    """``sa_run`` one-shot and chunked-resume: bitwise the JAX engine's
    nodes, inds, bests and moves; 1 and 2 threads give the same bits."""
    jt, tt = _pair(rng, random_seed)
    r = 6
    betas = np.linspace(0.0, 20.0, 40)
    seeds = np.arange(r, dtype=np.uint64) + random_seed
    want = jnative.sa_run(*_stack(jt, r), jt.log2_dims_array, betas, seeds,
                          n_threads=2, return_final=return_final)
    for threads in (1, 2):
        got = native.sa_run(*_stack(tt, r), tt.log2_dims_array, betas, seeds,
                            n_threads=threads, return_final=return_final)
        _equal(got, want)
    assert got[1] > 0


@pytest.mark.parametrize('rescue,return_final',
                         [(0, False), (0, True), (2, True)])
def test_sa_run_fw_matches_jax(rng, random_seed, rescue, return_final):
    """``sa_run_fw`` with reslices, ``return_final`` and the rescue
    ``max_new_slices``: bitwise the JAX engine's nodes, inds, slices,
    bests and moves, on 1 and 2 threads."""
    jt, tt = _pair(rng, random_seed)
    max_width = 3.0 if not rescue else 2.5
    r = 4
    log2d = jbitops.pad_log2_dims(jt.log2_dims_array, jt.inds_array.shape[1])
    slices0 = np.asarray(jsaf.init_state_fw(jt, 0, max_width, log2d).slices)
    slices = np.stack([slices0] * r)
    skip = np.zeros(jt.inds_array.shape[1], dtype=np.uint32)
    betas = np.linspace(0.0, 15.0, 30)
    seeds = np.arange(r, dtype=np.uint64) + random_seed
    kw = dict(reslice_every=0 if rescue else 7, max_new_slices=rescue,
              return_final=return_final)
    want = jnative.sa_run_fw(*_stack(jt, r), slices.copy(),
                             jt.log2_dims_array, skip, max_width, betas,
                             seeds, n_threads=2, **kw)
    for threads in (1, 2):
        got = native.sa_run_fw(*_stack(tt, r), slices.copy(),
                               tt.log2_dims_array, skip, max_width, betas,
                               seeds, n_threads=threads, **kw)
        _equal(got, want)
    assert got[1] > 0


def test_runner_native_matches_jax(random_seed):
    """``ReplicaRunner(engine='native')`` against the JAX runner over two
    chunks and a resumed run: bests, current and best trees, sweeps and
    moves, bitwise; the checkpoint refuses it."""
    jt, tt = _lattice_pairs(5, 5, 4, random_seed)
    seeds = [random_seed + i for i in range(4)]
    jr = jrep.ReplicaRunner(jt, seeds, cmodel=JIMModel(), engine='native')
    tr = trep.ReplicaRunner(tt, seeds, cmodel=TIMModel(), engine='native',
                            device='cpu')
    np.testing.assert_array_equal(tr.log2_min_totals(), jr.log2_min_totals())
    seen = []
    for betas in (np.linspace(0, 8, 10), np.linspace(8, 12, 3)):
        info = tr.run(betas, chunk_size=5, callback=seen.append)
        want = jr.run(betas, chunk_size=5)
        np.testing.assert_array_equal(info['log2_min_total'],
                                      want['log2_min_total'])
        assert (info['sweeps'], info['moves'], info['applied']) == \
            (want['sweeps'], want['moves'], want['applied'])
    assert [round(s['progress'], 2) for s in seen] == [0.5, 1.0, 1.0]
    assert tr.best() == jr.best()
    for i in range(4):
        for got, want in ((tr.min_ctree(i), jr.min_ctree(i)),
                          (tr.ctree(i), jr.ctree(i))):
            np.testing.assert_array_equal(got.nodes_array, want.nodes_array)
            np.testing.assert_array_equal(got.inds_array, want.inds_array)
            assert got.is_valid(check_shared_inds=True)
    with pytest.raises(ValueError, match="engine='native'"):
        save_runner('unused.npz', tr)
    with pytest.raises(ValueError, match='one beta per sweep'):
        tr.run(np.ones((2, 4)))


@pytest.mark.parametrize('rescue', [0, 2])
def test_runner_fw_native_matches_jax(random_seed, rescue):
    """``ReplicaRunnerFW(engine='native')`` against the JAX runner over two
    chunks: initial slices (the host greedy slicer), bests, trees,
    slices, sweeps and moves, bitwise, with and without the rescue."""
    jt, tt = _lattice_pairs(5, 5, 4, random_seed)
    seeds = [random_seed + i for i in range(4)]
    kw = dict(engine='native', max_number_new_slices=rescue)
    jr = jrep.ReplicaRunnerFW(jt, seeds, cmodel=JFWModel(max_width=5), **kw)
    tr = trep.ReplicaRunnerFW(tt, seeds, cmodel=TFWModel(max_width=5),
                              device='cpu', **kw)
    info = tr.run(np.linspace(0, 8, 12), update_slices=4, chunk_size=6)
    want = jr.run(np.linspace(0, 8, 12), update_slices=4, chunk_size=6)
    np.testing.assert_array_equal(info['log2_min_total'],
                                  want['log2_min_total'])
    assert (info['sweeps'], info['moves']) == (want['sweeps'],
                                               want['moves'])
    for i in range(4):
        np.testing.assert_array_equal(tr.slices_lanes(i), jr.slices_lanes(i))
        np.testing.assert_array_equal(tr.min_slices_lanes(i),
                                      jr.min_slices_lanes(i))
        for got, want_t in ((tr.min_ctree(i), jr.min_ctree(i)),
                            (tr.ctree(i), jr.ctree(i))):
            np.testing.assert_array_equal(got.nodes_array,
                                          want_t.nodes_array)
            np.testing.assert_array_equal(got.inds_array, want_t.inds_array)


def test_auto_routing_with_native(monkeypatch):
    """The counterpart of ``tests/test_parallel.py::test_auto_routing``
    with native on in both packages: a large dense network goes to
    'native' without an accelerator (IM and FW), and an FW runner with new
    slices goes to 'native' with one too; the port's 'auto' follows the
    library (``_native_available``)."""
    n_t = 900
    ts = [(i, i + 1) for i in range(n_t)]
    out = (0, n_t)
    dims = {i: 2 for i in range(n_t + 1)}
    path = [(0, 1)] * (n_t - 1)
    jt = [ContractionTree(path, ts, dims, output_inds=out)]
    tt = [TContractionTree(path, ts, dims, output_inds=out)]
    assert len(tt[0]) * tt[0].inds_array.shape[1] > 32768
    assert trep._native_available() and jnative.available()
    for accel in (False, True):
        monkeypatch.setattr(jrep, '_accel_available', lambda: accel)
        monkeypatch.setattr(trep, '_accel_available', lambda device: accel)
        cases = [(jrep.ReplicaRunner, trep.ReplicaRunner, {}, {}),
                 (jrep.ReplicaRunnerFW, trep.ReplicaRunnerFW,
                  dict(cmodel=JFWModel(max_width=30)),
                  dict(cmodel=TFWModel(max_width=30))),
                 (jrep.ReplicaRunnerFW, trep.ReplicaRunnerFW,
                  dict(cmodel=JFWModel(max_width=30),
                       max_number_new_slices=2),
                  dict(cmodel=TFWModel(max_width=30),
                       max_number_new_slices=2))]
        for jcls, tcls, jkw, tkw in cases:
            want = jcls(jt, [0], **jkw).engine
            got = tcls(tt, [0], device='cpu', **tkw).engine
            assert got == want
            if not accel or tkw.get('max_number_new_slices'):
                assert got == 'native'
    monkeypatch.setattr(trep, '_accel_available', lambda device: False)
    monkeypatch.setattr(trep, '_native_available', lambda: False)
    assert trep.ReplicaRunner(tt, [0], device='cpu').engine == 'vmapped'


def test_library_switches(monkeypatch, tmp_path):
    """``TNCO_TPU_NO_NATIVE`` and a host without g++ make the library
    unavailable (entry points return None, an explicit 'native' runner
    raises); a compile error of the source raises with g++'s output."""
    # The JAX trees below validate through the JAX library, which reads
    # the switch once, at its first load: load it before the switch.
    _, tt = _lattice_pairs(3, 3, 1)
    assert jnative.available()
    monkeypatch.setenv('TNCO_TPU_NO_NATIVE', '1')
    assert not native.available()
    assert native.validate(np.zeros((1, 3), np.int32),
                           np.zeros((1, 1), np.uint32)) is None
    assert not trep._native_available()
    with pytest.raises(RuntimeError, match='TNCO_TPU_NO_NATIVE'):
        trep.ReplicaRunner(tt, [0], engine='native', device='cpu')
    monkeypatch.delenv('TNCO_TPU_NO_NATIVE')
    monkeypatch.setattr(native, '_LIB', None)
    monkeypatch.setattr(native, 'LIB_PATH', tmp_path / 'libtnco_native.so')
    monkeypatch.setattr(native, 'BUILD_DIR', tmp_path)
    monkeypatch.setattr(native.shutil, 'which', lambda name: None)
    assert not native.available()
    monkeypatch.undo()
    broken = tmp_path / 'core.cpp'
    broken.write_text('int tnco_validate( {\n')
    monkeypatch.setattr(native, '_LIB', None)
    monkeypatch.setattr(native, '_SRC', broken)
    monkeypatch.setattr(native, 'LIB_PATH', tmp_path / 'libtnco_native.so')
    monkeypatch.setattr(native, 'BUILD_DIR', tmp_path)
    with pytest.raises(RuntimeError, match=r'(?s)g\+\+ failed.*: error'):
        native.available()
    assert not list(tmp_path.glob('*.tmp'))


def test_native_source_is_the_ports_own():
    """The port builds its own copy of the core under ``build/native/``:
    the same code as the JAX package's below the header comment, and no
    include or path of ``tnco_tpu/``."""
    import tnco_tpu.native as jmod
    from pathlib import Path
    mine = native._SRC.read_text()
    theirs = (Path(jmod.__file__).parent / 'core.cpp').read_text()
    strip = lambda s: s[s.index('#include'):]
    assert strip(mine) == strip(theirs)
    assert 'tnco_tpu/' not in mine.replace('tnco_tpu_torch/', '')
    assert native.LIB_PATH.parent.name == 'native'
    assert native.LIB_PATH.parent.parent.name == 'build'


@pytest.mark.parametrize('max_width', [None, 4.0])
def test_optimizer_native_matches_jax(random_seed, max_width):
    """``Optimizer(engine='native')`` (IM and, with ``max_width``, FW) on
    the CPU gives the JAX app's paths, costs and slices."""
    ts, out, dims = lattice_2d(4, 4)
    kw = dict(betas=(0, 8), n_steps=12, n_runs=3, fuse=0)
    jopt = japp.Optimizer(max_width=max_width, seed=random_seed,
                          engine='native')
    topt = tapp.Optimizer(max_width=max_width, seed=random_seed,
                          engine='native', device='cpu')
    jnet = JTN([JT(xs, tuple(dims[x] for x in xs)) for xs in ts],
               output_inds=out)
    tnet = TTN([TT(xs, tuple(dims[x] for x in xs)) for xs in ts],
               output_inds=out)
    _, jres = jopt.optimize(jnet, **kw)
    _, tres = topt.optimize(tnet, **kw)
    assert len(tres) == len(jres) == 3
    for t, j in zip(tres, jres):
        assert t.path == j.path
        assert t.disconnected_costs == j.disconnected_costs
        if max_width is not None:
            assert t.slices == j.slices


def test_cli_engine_native(capsys):
    """``tnco-tpu-torch optimize --engine native`` runs through the
    runners and prints a valid result."""
    argv = ['optimize', '[(2, "a", "b"), (2, "b", "c"), (2, "c", "d")]',
            '--betas=(0, 10)', '--n-steps=8', '--n-runs=2', '--seed=1',
            '--fuse=False', '--engine', 'native', '--device', 'cpu']
    assert tmain(argv) == 0
    got = json.loads(capsys.readouterr().out)
    assert [int(float(r['cost'])) for r in got['res']] == [10, 10]



def test_reference_loader_private_build(monkeypatch, tmp_path,
                                        reference_native):
    """The fixture's private build of the reference library survives what
    a worker that lost the shared build's race sees: a truncated library
    (the private one's ELF header alone, under ``tmp_path``, as g++ has
    begun to write it; a cut past the program headers would not fail to
    load but kill the process with SIGBUS) does not load and leaves the
    reference's entry points returning None, and the private build loads
    again after it.  No build of the reference in this process wrote the
    shared file."""
    private = reference_native._LIB_PATH
    assert private != SHARED_LIB and private.exists()
    jt, _ = _pair(Random(0), 0)
    want = reference_native.total_cost(jt.nodes_array, jt.inds_array,
                                       jt.dims_array)
    assert want is not None
    cut = tmp_path / SHARED_LIB.name
    cut.write_bytes(private.read_bytes()[:64])
    monkeypatch.setattr(reference_native, '_LIB_PATH', cut)
    monkeypatch.setattr(reference_native, '_LIB', None)
    monkeypatch.setattr(reference_native, '_TRIED', False)
    assert not reference_native.available()
    assert reference_native.total_cost(jt.nodes_array, jt.inds_array,
                                       jt.dims_array) is None
    assert cut.stat().st_size == 64
    monkeypatch.undo()
    monkeypatch.setattr(reference_native, '_LIB', None)
    monkeypatch.setattr(reference_native, '_TRIED', False)
    assert reference_native._LIB_PATH == private
    assert reference_native.available()
    assert reference_native.total_cost(jt.nodes_array, jt.inds_array,
                                       jt.dims_array) == want
    assert BUILD_TARGETS and all(Path(t) != SHARED_LIB
                                 for t in BUILD_TARGETS)

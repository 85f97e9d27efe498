"""The port's synchronous full-tree 'sweep' engine (``run_fullsweep``,
``run_fullsweep_fw``) and its runners vs the JAX package's
``sa_fullsweep``.

Each comparison starts both sides from one state (the JAX batch carried
across with :mod:`tnco_tpu_torch.convert`) and feeds the port the JAX
draws, mirrored from the replicas' threefry keys as ``_draws`` takes
them (``sa_fullsweep.py:159-167``): a 3-way split per round (4-way
finite width, whose fourth key draws the reslice jitter), the accept
uniforms from the second key and the bits (the D/E tie bit and the Luby
priority) from the third.  One round is compared at a time, with the JAX
state fed back: trees, index words, hyper, lcc, pre-slicing widths,
slices, the min state and the applied count bitwise; totals within 1e-5
in log2 (1e-12 in float64; PERF.md "Float bound").  Two kinds of float
ties are settled, and each is named where it is: end-of-round min
snapshots by ``test_torch_batched.min_ties``, reslice-if-better
decisions by ``test_torch_walks.reslice_ties``.  An accept decision
whose margin is under the float bound would be a legitimate
disagreement: the assertions name the smallest margins of the round
instead of loosening anything.
"""

import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tnco_tpu.kernels import sa_batched as jsb
from tnco_tpu.kernels import sa_finite_batched as jsfb
from tnco_tpu.kernels import sa_fullsweep as jsfs
from tnco_tpu.kernels.sa_finite import SweepConfigFW
from tnco_tpu.kernels.sa_fullsweep import uniform_log2_dim
from tnco_tpu.kernels.sa_infinite import SweepConfig
from tnco_tpu.ops import bitops as jbit
from tnco_tpu.ops import costs as jcost
from tnco_tpu.testing.utils import generate_random_tensors
from tnco_tpu.utils.tn import get_random_contraction_path
from tnco_tpu_torch.convert import (batch_from_numpy, batch_fw_from_numpy,
                                    batch_fw_to_numpy, batch_to_numpy)
from tnco_tpu_torch.ctree import ContractionTree as TContractionTree
from tnco_tpu_torch.kernels import gather as tgather
from tnco_tpu_torch.kernels import sa_batched as tsb
from tnco_tpu_torch.kernels import sa_finite_batched as tsfb
from tnco_tpu_torch.kernels import sa_fullsweep as tsfs
from tnco_tpu_torch.kernels.sa_finite import SweepConfigFW as TConfigFW
from tnco_tpu_torch.kernels.sa_infinite import SweepConfig as TConfig
from tnco_tpu_torch.kernels.sa_infinite import compute_hyper, compute_lcc
from tnco_tpu_torch.ops import costs as tcost
from test_torch_batched import (B, TOTAL_ATOL, compare, fields, min_ties,
                                network, trees)
from test_torch_batched_fw import MAX_WIDTH
from test_torch_sparse import N_PROJS, sparse_labels
from test_torch_walks import reslice_ties
from torch_reference_native import reference_native  # noqa: F401

TOTAL_ATOL64 = 1e-12


def _t(x):
    return torch.from_numpy(np.array(x, order='C'))


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _mirror(keys, ni, n_bits, fw, dtype):
    """One round's draws of ``_iter_fullsweep`` (``fw=False``, a 3-way
    split) or ``_iter_fullsweep_fw`` (a 4-way split, the last key the
    reslice jitter's), and the keys the round ends with."""
    parts = jax.vmap(lambda k: tuple(jax.random.split(k, 4 if fw else 3)))(
        keys)
    u = jax.vmap(lambda k: jax.random.uniform(k, (ni,), dtype=dtype))(
        parts[1])
    bits = jax.vmap(lambda k: jax.random.bits(k, (ni,)))(parts[2])
    jitter = (jax.vmap(lambda k: jax.random.uniform(
        k, (n_bits,), dtype=dtype))(parts[3]).T if fw else None)
    return parts[0], u, bits, jitter


def round_draws(batch, cfg, fw=False, dtype='float32'):
    """One round's JAX draws in the port's layout (leading round axis 1)
    and the keys the JAX round ends with."""
    ni = int(batch.c0.shape[0]) - cfg.n_leaves
    keys, u, bits, jitter = _mirror(batch.keys, ni, cfg.n_lanes * 32, fw,
                                    dtype)
    bits = np.asarray(bits)
    if bits.dtype == np.uint64:
        # Under x64 JAX draws 64-bit words: its engine reads the tie bit
        # as ``bits >> 31 != 0`` (any of bits 31..63) and the priority
        # from bits 30..15, which the port's word carries as its sign
        # bit and its low bits.
        bits = ((bits & 0x7FFFFFFF) |
                (((bits >> 31) != 0).astype(np.uint64) << 31)
                ).astype(np.uint32)
    dr = {'u': _t(u)[None], 'bits': _t(bits.view(np.int32))[None]}
    if fw:
        dr['jitter'] = _t(jitter)[None]
    return dr, np.asarray(keys)


class Margins:
    """Records the margins of the port's accept decisions through
    ``tsfs._accept``: ``|log2 u + beta * delta|`` ('mh', 'mh_local'),
    ``|delta|`` ('greedy')."""

    def __init__(self, monkeypatch):
        self.seen = []
        original = tsfs._accept

        def accept(ev, lt, u, beta, prob_kind):
            if prob_kind in ('mh', 'greedy'):
                d = tcost.delta_log2_local(lt[:, None], ev['l_a'], ev['l_b'],
                                           ev['ln_a'], ev['ln_b'])
            elif prob_kind == 'mh_local':
                d = (torch.log2(torch.exp2(ev['ln_a']) +
                                torch.exp2(ev['ln_b'])) -
                     torch.log2(torch.exp2(ev['l_a']) +
                                torch.exp2(ev['l_b'])))
            if prob_kind != 'base':
                bb = beta[:, None] if beta.dim() else beta
                m = (d if prob_kind == 'greedy' else
                     torch.log2(u) + bb * d).abs()
                m = m[ev['a'] != -1]
                self.seen.extend(float(x) for x in m.reshape(-1))
            return original(ev, lt, u, beta, prob_kind)

        monkeypatch.setattr(tsfs, '_accept', accept)

    def smallest(self):
        return sorted(self.seen)[:3]


def _check(ref, got, what, margins, atol=TOTAL_ATOL):
    try:
        compare(ref, got, what)
    except AssertionError as e:
        raise AssertionError(
            f'{e}\nSmallest accept margins of the port: '
            f'{margins.smallest()} (float bound {atol})') from None


def _setup(kind, seed, fw=False, prob_kind='mh_local', dsi=False,
           dtype=np.float32):
    ts, out, dims = network(kind, seed)
    ctrees = trees(ts, out, dims, seed)
    t = ctrees[0]
    w = t.inds_array.shape[1]
    log2d = np.array(jbit.pad_log2_dims(t.log2_dims_array, w,
                                        jnp.dtype(dtype)))
    seeds = [seed + r for r in range(B)]
    flags = dict(n_leaves=t.n_leaves, n_lanes=w, prob_kind=prob_kind,
                 disable_shared_inds=dsi)
    if fw:
        batch = jsfb.init_batch_fw(ctrees, seeds, MAX_WIDTH[kind], log2d,
                                   dtype=dtype)
        cfgs = SweepConfigFW(**flags), TConfigFW(**flags)
    else:
        batch = jsb.init_batch(ctrees, seeds, log2d, dtype=dtype)
        cfgs = SweepConfig(**flags), TConfig(**flags)
    # The JAX runners pass the common log2 dim as it is (replicas.py:932).
    ul = uniform_log2_dim(t.log2_dims_array)
    return batch, cfgs, log2d.reshape(w, 32), ul, ctrees


def _sparse(ctrees, seed, kind):
    """A random third of the indices sparse: the JAX and port engine
    inputs ``(sparse_wb [W, 1], log2_n_projs)``."""
    from tnco_tpu.optimize.infinite_memory import SimpleCostModel
    order = ctrees[0].inds_order
    labels = sparse_labels([[x] for x in order], seed)
    dev = SimpleCostModel(sparse_inds=labels,
                          n_projs=N_PROJS[kind]).device_params(order)
    lanes = dev['sparse_lanes']
    return ((jnp.asarray(lanes)[:, None], dev['log2_n_projs']),
            (_t(lanes.view(np.int32))[:, None], dev['log2_n_projs']))


def _betas(i, b, lanes):
    beta = np.float32(0.5 + 1.5 * i)
    if lanes:                                   # a per-lane ladder [1, B]
        return (beta * np.linspace(0.25, 2.0, b, dtype=np.float32))[None]
    return np.asarray([beta], np.float32)


IM_CASES = [
    # kind, prob_kind, disable_shared_inds, per-lane betas, sparse
    ('lattice', 'mh_local', False, False, False),
    ('lattice', 'mh', False, False, False),
    ('lattice', 'greedy', False, False, False),
    ('lattice', 'base', False, False, False),
    ('mixed', 'mh_local', False, True, False),
    ('mixed', 'mh', True, False, False),
    ('hyper', 'mh_local', True, False, False),
    ('hyper', 'mh', False, True, False),
    ('lattice', 'mh_local', False, False, True),
    ('mixed', 'mh', False, False, True),
]


@pytest.mark.parametrize('kind,prob_kind,dsi,lanes,sparse', IM_CASES)
def test_round_im_matches_jax(monkeypatch, random_seed, kind, prob_kind, dsi,
                              lanes, sparse):
    """One ``_iter_fullsweep`` at a time, 4 rounds, the JAX state fed
    back."""
    seed = random_seed % 1000
    batch, (cfg, tcfg), log2d_w32, ul, ctrees = _setup(
        kind, seed, prob_kind=prob_kind, dsi=dsi)
    jsp, tsp = _sparse(ctrees, seed, kind) if sparse else ((), ())
    applied = 0
    for i in range(4):
        margins = Margins(monkeypatch)
        betas = _betas(i, B, lanes)
        dr, keys_out = round_draws(batch, cfg)
        ref, rm = jsfs.run_fullsweep(batch, jnp.asarray(betas),
                                     jnp.asarray(log2d_w32), cfg, *jsp,
                                     uniform_log2=ul)
        np.testing.assert_array_equal(keys_out, np.asarray(ref.keys))
        got, gm = tsfs.run_fullsweep(batch_from_numpy(fields(batch), 'cpu'),
                                     betas, _t(log2d_w32), tcfg, *tsp,
                                     uniform_log2=ul, draws=dr)
        what = f'{kind} {prob_kind} round {i}'
        g = batch_to_numpy(got)
        min_ties(batch, ref, g)
        _check(ref, g, what, margins)
        assert int(gm['applied']) == int(rm['applied']), what
        assert int(gm['moves']) == int(rm['moves']), what
        applied += int(rm['applied'])
        batch = ref
    assert applied > 0


FW_CASES = [
    # kind, prob_kind, reslice, sparse
    ('lattice', 'mh_local', True, False),
    ('lattice', 'mh', False, False),
    ('lattice', 'greedy', True, False),
    ('mixed', 'mh_local', True, False),
    ('mixed', 'base', True, False),
    ('hyper', 'mh', True, False),
    ('lattice', 'mh_local', True, True),
    ('mixed', 'mh', True, True),
]


@pytest.mark.parametrize('kind,prob_kind,reslice,sparse', FW_CASES)
def test_round_fw_matches_jax(monkeypatch, random_seed, kind, prob_kind,
                              reslice, sparse):
    """One ``_iter_fullsweep_fw`` at a time, 4 rounds (a reslice after
    rounds 0 and 2 where on), the JAX state fed back."""
    seed = random_seed % 1000
    batch, (cfg, tcfg), log2d_w32, ul, ctrees = _setup(
        kind, seed, fw=True, prob_kind=prob_kind)
    jsp, tsp = _sparse(ctrees, seed, kind) if sparse else ((None, None),) * 2
    w = cfg.n_lanes
    skip = np.zeros(w, dtype=np.uint32)
    mw = MAX_WIDTH[kind]
    for i in range(4):
        upd = reslice and i % 2 == 0
        margins = Margins(monkeypatch)
        betas = _betas(i, B, False)
        dr, keys_out = round_draws(batch, cfg, fw=True)
        ref, rm = jsfs.run_fullsweep_fw(
            batch, jnp.asarray(betas), jnp.asarray([upd]), mw,
            jnp.asarray(log2d_w32), jnp.asarray(skip), cfg, *jsp,
            uniform_log2=ul)
        np.testing.assert_array_equal(keys_out, np.asarray(ref.keys))
        got, gm = tsfs.run_fullsweep_fw(
            batch_fw_from_numpy(fields(batch), 'cpu'), betas, [upd], mw,
            _t(log2d_w32), _t(skip.view(np.int32)), tcfg, *tsp,
            uniform_log2=ul, draws=dr)
        what = f'{kind} {prob_kind} round {i}'
        g = batch_fw_to_numpy(got)
        if upd:
            # A reslice decided by a float tie (named here).
            reslice_ties(batch, ref, g, jnp.asarray(log2d_w32), ul,
                         cfg.n_leaves, *jsp)
        min_ties(batch, ref, g)
        _check(ref, g, what, margins)
        assert int(gm['applied']) == int(rm['applied']), what
        batch = ref
    assert np.asarray(batch.slices).any()


@pytest.mark.parametrize('fw', [False, True])
def test_round_float64_matches_jax(monkeypatch, random_seed, fw):
    """Float64 state (under ``jax.enable_x64``; the reference slicer, as
    JAX's plane slicer fails under x64): 3 rounds, totals within
    1e-12."""
    seed = random_seed % 1000
    with jax.enable_x64(True):
        batch, (cfg, tcfg), log2d_w32, ul, _ = _setup(
            'mixed', seed, fw=fw, prob_kind='mh', dtype=np.float64)
        assert batch.lcc.dtype == jnp.float64 and ul is None
        skip = np.zeros(cfg.n_lanes, dtype=np.uint32)
        for i in range(3):
            margins = Margins(monkeypatch)
            betas = np.asarray([0.5 + 1.5 * i])
            dr, keys_out = round_draws(batch, cfg, fw, 'float64')
            if fw:
                ref, rm = jsfs.run_fullsweep_fw(
                    batch, jnp.asarray(betas), jnp.asarray([i % 2 == 0]),
                    MAX_WIDTH['mixed'], jnp.asarray(log2d_w32),
                    jnp.asarray(skip), cfg)
                got, gm = tsfs.run_fullsweep_fw(
                    batch_fw_from_numpy(fields(batch), 'cpu'), betas,
                    [i % 2 == 0], MAX_WIDTH['mixed'], _t(log2d_w32),
                    _t(skip.view(np.int32)), tcfg, draws=dr)
                g = batch_fw_to_numpy(got)
            else:
                ref, rm = jsfs.run_fullsweep(batch, jnp.asarray(betas),
                                             jnp.asarray(log2d_w32), cfg)
                got, gm = tsfs.run_fullsweep(
                    batch_from_numpy(fields(batch), 'cpu'), betas,
                    _t(log2d_w32), tcfg, draws=dr)
                g = batch_to_numpy(got)
            assert got.lcc.dtype == torch.float64
            for k in ('log2_total', 'min_log2_total'):
                np.testing.assert_allclose(g[k], np.asarray(getattr(ref, k)),
                                           rtol=0, atol=TOTAL_ATOL64)
            min_ties(batch, ref, g)
            _check(ref, g, f'float64 fw={fw} round {i}', margins,
                   TOTAL_ATOL64)
            assert int(gm['applied']) == int(rm['applied'])
            batch = ref


# --- the counterparts of tests/test_sa_fullsweep.py ------------------------


def _port_setup(rng, random_seed, n_replicas=6, **kw):
    """Port trees of a random network (``test_sa_fullsweep._setup``)."""
    ts_inds, output_inds, dims = generate_random_tensors(
        rng, n_output_inds=2, **kw)
    order = tuple(dict.fromkeys(x for xs in ts_inds for x in xs))
    ctrees = []
    for r in range(n_replicas):
        (path,) = [p for p in get_random_contraction_path(
            ts_inds, output_inds, merge_paths=False,
            seed=random_seed + r) if p]
        ctrees.append(TContractionTree(path, ts_inds, dims,
                                       output_inds=output_inds,
                                       check_shared_inds=True,
                                       inds_order=order))
    return ctrees, ts_inds, output_inds, dims


def _port_batch(ctrees, fw=False, max_width=None, prob_kind='mh'):
    from tnco_tpu_torch.ops import bitops
    t = ctrees[0]
    w = t.inds_array.shape[1]
    log2d = bitops.pad_log2_dims(t.log2_dims_array, w, torch.float32, 'cpu')
    seeds = list(range(len(ctrees)))
    flags = dict(n_leaves=t.n_leaves, n_lanes=w, prob_kind=prob_kind)
    if fw:
        batch = tsfb.init_batch_fw(ctrees, seeds, max_width, log2d.numpy(),
                                   device='cpu')
        return batch, TConfigFW(**flags), log2d
    batch = tsb.init_batch(ctrees, seeds, log2d.numpy(), device='cpu')
    return batch, TConfig(**flags), log2d


def _valid(tree):
    ok, msg = tree.is_valid(check_shared_inds=True, return_message=True)
    assert ok, msg


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _tree(template, b, i, best=True):
    p = 'min_' if best else ''
    nodes = np.stack([getattr(b, p + k)[:, i].numpy()
                      for k in ('c0', 'c1', 'par')], axis=1)
    return template.replace_arrays(
        nodes, getattr(b, p + 'inds')[..., i].numpy().view(np.uint32))


def _audit_im(out, ctrees, log2d):
    t = ctrees[0]
    for i in range(len(ctrees)):
        tree = _tree(t, out, i, best=False)
        _valid(tree)
        nodes = torch.stack([out.c0[:, i], out.c1[:, i], out.par[:, i]], 1)
        lcc_ref = compute_lcc(nodes, out.inds[..., i], log2d).numpy()
        got = out.lcc[:, i].numpy()
        fin = np.isfinite(lcc_ref)
        np.testing.assert_allclose(got[fin], lcc_ref[fin], atol=1e-4)
        np.testing.assert_array_equal(
            out.hyper[..., i].numpy(),
            compute_hyper(nodes, out.inds[..., i]).numpy())
        mtree = _tree(t, out, i)
        _valid(mtree)
        assert float(out.min_log2_total[i]) == pytest.approx(
            math.log2(mtree.total_cost_exact()), abs=1e-3)


@pytest.mark.parametrize('prob_kind', ['mh', 'mh_local'])
def test_fullsweep_validity_and_audits(rng, random_seed, prob_kind):
    """50 rounds from the generator: valid trees, lcc and hyper caches
    against a recompute, exact min costs (and, 'mh_local', the engine
    default of the runners)."""
    ctrees, *_ = _port_setup(rng, random_seed)
    batch, cfg, log2d = _port_batch(ctrees, prob_kind=prob_kind)
    b = len(ctrees)
    out, metrics = tsfs.run_fullsweep(
        batch, np.linspace(0.0, 10.0, 50), log2d.reshape(-1, 32), cfg,
        generator=_gen())
    ni = len(ctrees[0]) - ctrees[0].n_leaves
    assert int(metrics['moves']) == 50 * ni * b
    assert 0 < int(metrics['applied']) <= int(metrics['moves'])
    _audit_im(out, ctrees, log2d)


def test_fullsweep_deterministic(rng, random_seed):
    ctrees, *_ = _port_setup(rng, random_seed, n_replicas=4)
    batch, cfg, log2d = _port_batch(ctrees)
    args = (batch, np.linspace(0.0, 10.0, 30), log2d.reshape(-1, 32), cfg)
    ref, mref = tsfs.run_fullsweep(*args, generator=_gen(5))
    got, mgot = tsfs.run_fullsweep(*args, generator=_gen(5))
    assert int(mref['applied']) == int(mgot['applied'])
    for k in ref.field_names():
        assert torch.equal(getattr(ref, k), getattr(got, k)), k


def test_fullsweep_greedy_monotone(rng, random_seed):
    """Greedy synchronous moves never raise the total (each delta <= 0,
    kept moves touch disjoint contractions)."""
    ctrees, *_ = _port_setup(rng, random_seed, n_replicas=4)
    batch, cfg, log2d = _port_batch(ctrees, prob_kind='greedy')
    prev = batch.log2_total.numpy()
    gen = _gen()
    for _ in range(6):
        batch, _m = tsfs.run_fullsweep(batch, np.zeros(8),
                                       log2d.reshape(-1, 32), cfg,
                                       generator=gen)
        cur = batch.log2_total.numpy()
        assert np.all(cur <= prev + 1e-3)
        prev = cur


def _audit_fw(template, out, max_width, n):
    from tnco_tpu_torch.optimize.finite_width import SimpleCostModel
    cm = SimpleCostModel(max_width=max_width)
    for i in range(n):
        tree = _tree(template, out, i)
        _valid(tree)
        sl = out.min_slices[:, i].numpy().view(np.uint32)
        labels = _labels(template, sl)
        for xs in tree.inds:
            assert cm.width(frozenset(xs) - labels,
                            tree.dims) <= max_width + 1e-3
        total = 0
        tins = tree.inds
        for node in tree.nodes:
            if not node.is_leaf():
                union = (frozenset(tins[node.children[0]]) |
                         frozenset(tins[node.children[1]]) | labels)
                total += math.prod(tree.dims[x] for x in union)
        assert float(out.min_log2_total[i]) == pytest.approx(
            math.log2(total), abs=1e-3)


def _labels(template, lanes):
    from tnco_tpu_torch.bitset import Bitset
    return frozenset(template.inds_order[p] for p in Bitset.from_lanes(
        lanes, template.n_inds).positions())


def test_fullsweep_fw_validity_and_audits(rng, random_seed):
    max_width = 2.5
    ctrees, *_ = _port_setup(rng, random_seed,
                                                     n_replicas=4)
    batch, cfg, log2d = _port_batch(ctrees, fw=True, max_width=max_width)
    w = cfg.n_lanes
    out, metrics = tsfs.run_fullsweep_fw(
        batch, np.linspace(0.0, 10.0, 60), np.arange(60) % 10 == 0,
        max_width, log2d.reshape(w, 32), torch.zeros(w, dtype=torch.int32),
        cfg, generator=_gen())
    assert 0 < int(metrics['applied']) <= int(metrics['moves'])
    _audit_fw(ctrees[0], out, max_width, 4)


def test_fullsweep_sparse_cost_model(rng, random_seed):
    """A sparse cost model through the runner: the best device total
    equals the cost model's exact recompute of its tree."""
    from tnco_tpu_torch.optimize.infinite_memory import SimpleCostModel
    from tnco_tpu_torch.parallel.replicas import ReplicaRunner

    ctrees, *_ = _port_setup(rng, random_seed,
                                                     n_replicas=4)
    sparse = frozenset(sorted(map(str, ctrees[0].all_inds()))[:2])
    cm = SimpleCostModel(sparse_inds=sparse, n_projs=2)
    run = ReplicaRunner(ctrees, list(range(4)), cmodel=cm, engine='sweep',
                        device='cpu')
    run.run(np.linspace(0, 8, 40), chunk_size=20)
    best_i, best = run.best()
    tree = run.min_ctree(best_i)
    _valid(tree)
    tins = tree.inds
    total = sum(cm.contraction_cost(tins[node.children[0]],
                                    tins[node.children[1]], tins[p],
                                    tree.dims)
                for p, node in enumerate(tree.nodes) if not node.is_leaf())
    assert best == pytest.approx(math.log2(total), abs=1e-3)


def test_fullsweep_runner(rng, random_seed):
    from tnco_tpu_torch.parallel.replicas import ReplicaRunner

    ctrees, *_ = _port_setup(rng, random_seed,
                                                     n_replicas=5)
    run = ReplicaRunner(ctrees, list(range(5)), engine='sweep', device='cpu')
    ni = len(ctrees[0]) - ctrees[0].n_leaves
    out = run.run(np.linspace(0, 10, 48), chunk_size=16)
    assert out['moves'] == 48 * ni * 5
    assert 0 < out['applied'] <= out['moves']
    best_i, best = run.best()
    tree = run.min_ctree(best_i)
    _valid(tree)
    assert best == pytest.approx(math.log2(tree.total_cost_exact()),
                                 abs=1e-3)


def test_fullsweep_fw_runner(rng, random_seed):
    """The FW engine through the runner: widths within the cap after
    slicing, exact slice-aware min costs."""
    from tnco_tpu_torch.optimize.finite_width import SimpleCostModel
    from tnco_tpu_torch.parallel.replicas import ReplicaRunnerFW

    max_width = 2.5
    ctrees, *_ = _port_setup(rng, random_seed,
                                                     n_replicas=4)
    run = ReplicaRunnerFW(ctrees, list(range(4)),
                          cmodel=SimpleCostModel(max_width=max_width),
                          engine='sweep', device='cpu')
    assert run.cfg.prob_kind == 'mh_local'
    run.run(np.linspace(0, 10, 64), chunk_size=32, update_slices=8)
    _audit_fw(ctrees[0], run.states, max_width, 4)


def test_fullsweep_k1_reads(monkeypatch, rng, random_seed):
    """The counterpart of the interpret-vs-XLA gather test: a round makes
    seven K1 reads at the planes and id counts the engine gives them,
    and a run whose reads go straight to ``gather_plain`` (the kernel's
    yardstick) is the same bitwise."""
    ctrees, *_ = _port_setup(rng, random_seed, n_replicas=3)
    batch, cfg, log2d = _port_batch(ctrees, prob_kind='mh_local')
    n, ni, w = len(ctrees[0]), len(ctrees[0]) - cfg.n_leaves, cfg.n_lanes
    args = (batch, np.linspace(0.0, 8.0, 3), log2d.reshape(-1, 32), cfg)
    ref, mref = tsfs.run_fullsweep(*args, generator=_gen(3))
    shapes = []
    plain = tgather.gather_plain

    def rec(vals, ids, *, planes=None):
        lo, hi = (0, vals.shape[0]) if planes is None else planes
        shapes.append((hi - lo, ids.shape[1]))
        return plain(vals, ids, planes)

    monkeypatch.setattr(tsfs, 'gather_gbn', rec)
    got, mgot = tsfs.run_fullsweep(*args, generator=_gen(3))
    per_round = [(w + 4, ni), (w + 2, 4 * ni), (1, 12 * ni), (3, 2 * n),
                 (3, n), (1, n), (1, n)]
    assert shapes == per_round * 3
    assert int(mref['applied']) == int(mgot['applied'])
    for k in ref.field_names():
        assert torch.equal(getattr(ref, k), getattr(got, k)), k


def test_fullsweep_popcount_width_matches_pinned(rng, random_seed):
    """On an all-dim-2 network the popcount widths equal the pinned
    bit-plane widths bitwise (integer float sums)."""
    ctrees, *_ = _port_setup(rng, random_seed, n_replicas=4, min_dim=2,
                             max_dim=2)
    batch, cfg, log2d = _port_batch(ctrees)
    ul = tsfs.uniform_log2_dim(ctrees[0].log2_dims_array)
    assert ul == 1.0
    args = (batch, np.linspace(0.0, 8.0, 12), log2d.reshape(-1, 32), cfg)
    ref, mref = tsfs.run_fullsweep(*args, generator=_gen(1))
    got, mgot = tsfs.run_fullsweep(*args, generator=_gen(1), uniform_log2=ul)
    assert int(mref['applied']) == int(mgot['applied'])
    for k in ref.field_names():
        assert torch.equal(getattr(ref, k), getattr(got, k)), k


def test_delta_log2_local_precision(random_seed):
    """``delta_log2_local`` keeps the delta's sign and digits where the
    subtraction form rounds to 0, and equals the JAX function on random
    inputs within an ulp."""
    f = torch.tensor

    def both(*xs):
        direct = tcost.new_total_log2(*(f(x) for x in xs)) - f(xs[0])
        return float(direct), float(tcost.delta_log2_local(
            *(f(x) for x in xs)))

    direct, local = both(20.0, 18.0, 15.0, 17.0, 16.0)
    assert local == pytest.approx(direct, abs=1e-5)
    exact = math.log2(2**20.0 - 2**18 - 2**15 + 2**17 + 2**16) - 20.0
    assert local == pytest.approx(exact, rel=1e-5)
    direct, local = both(84.0, 44.0, 40.0, 45.0, 41.0)
    assert direct == 0.0
    exact = math.log2(2**84.0 - 2**44 - 2**40 + 2**45 + 2**41) - 84.0
    assert local == pytest.approx(exact, rel=1e-4) and local > 0.0
    assert both(84.0, 45.0, 41.0, 44.0, 40.0)[1] < 0.0

    r = np.random.default_rng(random_seed)
    lt = r.uniform(20, 90, 2000).astype(np.float32)
    xs = [(lt - r.uniform(0, 40, 2000)).astype(np.float32)
          for _ in range(4)]
    want = np.asarray(jcost.delta_log2_local(*(jnp.asarray(x)
                                               for x in [lt] + xs)))
    got = tcost.delta_log2_local(*(_t(x) for x in [lt] + xs)).numpy()
    # XLA's and torch's exp2/log1p differ by an ulp here and there, which
    # log1p near -1 magnifies (up to 11 ulps over seeds 0-4): the bound is
    # 32 ulps of the largest term, 2^(m - lt), plus of the result.  (-inf
    # where a move removes the whole total, on both sides.)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    scale = np.exp2(np.max(xs, axis=0) - lt)[fin]
    assert np.all(np.abs(got[fin] - want[fin]) <=
                  32 * 2.0**-24 * (scale + np.abs(want[fin])))


def test_runner_sweep_routing():
    """'sweep' in both runners: ``prob_kind`` None means 'mh_local';
    'mh_local' elsewhere, ``max_number_new_slices`` on 'sweep' and a mesh
    raise; 'auto' never picks it; exchange runs on it (lane-major)."""
    from benchmarks.networks import lattice_2d
    from tnco_tpu_torch.optimize.finite_width import SimpleCostModel
    from tnco_tpu_torch.parallel import replicas as trep
    ts, out, dims = lattice_2d(3, 4)
    ctrees = [TContractionTree(get_random_contraction_path(
        ts, out, seed=s), ts, dims, output_inds=out) for s in (0, 1)]
    kw = dict(device='cpu')
    r = trep.ReplicaRunner(ctrees, [0, 1], engine='sweep', **kw)
    assert r.cfg.prob_kind == 'mh_local' and r.engine in trep._LANE_MAJOR
    assert trep.ReplicaRunner(ctrees, [0, 1], engine='batched',
                              **kw).cfg.prob_kind == 'mh'
    with pytest.raises(ValueError, match='mh_local'):
        trep.ReplicaRunner(ctrees, [0, 1], engine='batched',
                           prob_kind='mh_local', **kw)
    cm = SimpleCostModel(max_width=3)
    f = trep.ReplicaRunnerFW(ctrees, [0, 1], cmodel=cm, engine='sweep',
                             prob_kind='greedy', **kw)
    assert f.cfg.prob_kind == 'greedy'
    with pytest.raises(ValueError, match='max_number_new_slices'):
        trep.ReplicaRunnerFW(ctrees, [0, 1], cmodel=cm, engine='sweep',
                             max_number_new_slices=2, **kw)
    with pytest.raises(ValueError, match='multi-chip'):
        trep.ReplicaRunner(ctrees, [0, 1], engine='sweep', mesh=object(),
                           **kw)
    for fw in (False, True):
        for accel in (False, True):
            assert trep.resolve_engine(
                40000, 1, accel=accel, native=False, sparse=False,
                max_new_slices=0, disable_shared_inds=False,
                prob_kind=None, fw=fw) != 'sweep'
    res = f.run(np.linspace(0, 4, 8), chunk_size=2, exchange_every=1,
                exchange_islands=1)
    assert res['applied'] is not None and res['sweeps'] == 8
    r.run(np.stack([np.linspace(0, 4, 6)] * 2, axis=1), chunk_size=3,
          exchange_every=1)
    assert r.sweeps_done == 6


def test_runner_sweep_matches_jax_runner(monkeypatch, random_seed):
    """The runner's chunk loop calls the engine as the JAX runner does
    (the common log2 dim as it is, prob_kind 'mh_local'): from one state,
    with the JAX draws of each round injected, one chunk of 3 rounds
    equals the JAX runner's, and so do the moves and applied counts."""
    from tnco_tpu.parallel import replicas as jrep
    from tnco_tpu_torch.parallel import replicas as trep
    seed = random_seed % 1000
    ts, out, dims = network('lattice', seed)
    jt = trees(ts, out, dims, seed)
    jr = jrep.ReplicaRunner(jt, list(range(B)), engine='sweep')
    tr = trep.ReplicaRunner(_port_trees(ts, out, dims, seed,
                                        jt[0].inds_order),
                            list(range(B)), engine='sweep', device='cpu')
    assert jr.cfg.prob_kind == tr.cfg.prob_kind == 'mh_local'
    compare(jr.states, batch_to_numpy(tr.states), 'init')
    betas = np.linspace(0.5, 3.0, 3).astype(np.float32)
    per, b = [], jr.states
    for beta in betas:
        dr, _ = round_draws(b, jr.cfg)
        per.append(dr)
        b, _ = jsfs.run_fullsweep(b, jnp.asarray([beta]), jr.log2d_w32,
                                  jr.cfg, uniform_log2=1.0)
    draws = {k: torch.cat([d[k] for d in per]) for k in per[0]}
    orig = tsfs.run_fullsweep

    def injected(*a, generator=None, **k):
        assert generator is tr.generator and k['uniform_log2'] == 1.0
        return orig(*a, draws=draws, **k)

    start = jr.states
    jr.run(betas, chunk_size=3)
    monkeypatch.setattr(tsfs, 'run_fullsweep', injected)
    tr.run(betas, chunk_size=3)
    g = batch_to_numpy(tr.states)
    min_ties(start, jr.states, g)
    compare(jr.states, g, 'runner chunk')
    assert tr.moves_done == jr.moves_done
    assert tr.applied_done == jr.applied_done


def _port_trees(ts, out, dims, seed, order):
    res = []
    for r in range(B):
        (path,) = [p for p in get_random_contraction_path(
            ts, out, merge_paths=False, seed=seed + r) if p]
        res.append(TContractionTree(path, ts, dims, output_inds=out,
                                    check_shared_inds=True,
                                    inds_order=order))
    return res


@pytest.mark.cuda
def test_round_card_matches_cpu(random_seed):
    """One IM round and one FW round with a reslice on the card against
    the CPU, from one state with the same draws: bitwise integer and bit
    state, totals within 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    seed = random_seed % 1000
    for fw in (False, True):
        batch, (cfg, tcfg), log2d_w32, ul, _ = _setup('lattice', seed, fw=fw)
        dr, _ = round_draws(batch, cfg, fw=fw)
        skip = torch.zeros(cfg.n_lanes, dtype=torch.int32)
        outs = []
        for dev in ('cpu', 'cuda'):
            conv = batch_fw_from_numpy if fw else batch_from_numpy
            tb = conv(fields(batch), dev)
            d = {k: v.to(dev) for k, v in dr.items()}
            if fw:
                o, _ = tsfs.run_fullsweep_fw(
                    tb, [1.0], [True], MAX_WIDTH['lattice'],
                    _t(log2d_w32).to(dev), skip.to(dev), tcfg,
                    uniform_log2=ul, draws=d)
                outs.append(batch_fw_to_numpy(o))
            else:
                o, _ = tsfs.run_fullsweep(tb, [1.0], _t(log2d_w32).to(dev),
                                          tcfg, uniform_log2=ul, draws=d)
                outs.append(batch_to_numpy(o))
        for k, v in outs[0].items():
            if k in ('log2_total', 'min_log2_total'):
                np.testing.assert_allclose(outs[1][k], v, rtol=0,
                                           atol=TOTAL_ATOL)
            else:
                np.testing.assert_array_equal(outs[1][k], v, err_msg=k)


@pytest.mark.parametrize('max_width', [None, 4.0])
def test_optimizer_and_cli_sweep(monkeypatch, capsys, tmp_path, max_width):
    """``Optimizer(engine='sweep')`` (IM, and FW with ``max_width``) and
    ``tnco-tpu-torch optimize --engine sweep`` reach the engine; every
    result is a valid path at its exact cost."""
    from decimal import Decimal
    from test_torch_batched import _lattice_tn
    from tnco_tpu_torch.app import Optimizer
    from tnco_tpu_torch.app.cli import main
    from tnco_tpu_torch.app.finite_width import sa as fw_sa
    from tnco_tpu_torch.app.finite_width.sa import _exact_component_cost
    from tnco_tpu_torch.app.infinite_memory import sa as im_sa
    from tnco_tpu_torch.optimize.finite_width import SimpleCostModel
    module, name = ((im_sa, 'ReplicaRunner') if max_width is None else
                    (fw_sa, 'ReplicaRunnerFW'))
    made = []
    cls = getattr(module, name)

    def make(*a, **k):
        made.append(cls(*a, **k))
        return made[-1]

    monkeypatch.setattr(module, name, make)
    kw = {} if max_width is None else {'max_width': max_width}
    loaded, res = Optimizer(seed=1, device='cpu', engine='sweep',
                            **kw).optimize(_lattice_tn(4, 5), betas=(0, 10),
                                           n_steps=12, n_runs=3, fuse=0)
    assert [r.engine for r in made] == ['sweep']
    assert made[0].applied_done > 0
    cm = SimpleCostModel(max_width=max_width or 1e9)
    for r in res:
        tree = TContractionTree(r.path, loaded.ts_inds, loaded.dims,
                                output_inds=loaded.output_inds)
        _valid(tree)
        slices = getattr(r, 'slices', frozenset())
        assert r.cost == Decimal(_exact_component_cost(tree, cm, slices))
    path = tmp_path / 'ring.txt'
    path.write_text('2 a b\n2 b c\n2 c d\n2 d a\n2 a c\n')
    args = ['optimize', str(path), '--fuse', '0', '--betas', '(0, 10)',
            '--n-steps', '8', '--n-runs', '2', '--seed', '1', '--engine',
            'sweep', '--device', 'cpu']
    if max_width is not None:
        args += ['--max-width', '2']
    made.clear()
    assert main(args) == 0
    assert [r.engine for r in made] == ['sweep']
    assert '"res"' in capsys.readouterr().out

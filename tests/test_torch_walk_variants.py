"""The walk variants of the port's walk engines vs the JAX package: the
infinite-memory ``run_walks``, ``claim='pairwise'``, ``on_block``
'restart' and 'dedup', ``accept_rule='chained'``, ``prob_kind``
'mh_local', 'greedy' and 'base', and ``walk_chunk``.

Each comparison starts both sides from one state (the JAX batch carried
across with :mod:`tnco_tpu_torch.convert`) and feeds the port the JAX
draws (``sa_multiwalk._draws`` of the replicas' keys, which the JAX
walks and multi-walk engines both draw).  One iteration is compared at a
time, for several iterations in turn with the JAX state fed back: walk
positions, counters, trees, index words, slices and the min state
bitwise; ``lcc`` bitwise (exact integers on dim-2 networks, the pinned
tree elsewhere); totals within 1e-5 in log2 (the exp2/log2 gap between
XLA and torch).  The port's walks engine is also held bitwise to its
multi-walk engine on the same draws, totals included.  Min snapshots
decided by a tie within the float bound (the greedy rule's neutral moves
give them) are settled by ``test_torch_batched.min_ties``, reslices
decided so by ``test_torch_walks.reslice_ties``; any other decision
whose margin is under the float bound would be a legitimate
disagreement: the assertions name the smallest margins instead of
loosening anything.
"""

from decimal import Decimal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tnco_tpu.ctree import ContractionTree
from tnco_tpu.kernels import sa_batched as jsb
from tnco_tpu.kernels import sa_finite_batched as jsfb
from tnco_tpu.kernels import sa_multiwalk as jsmw
from tnco_tpu.kernels import sa_walks as jsw
from tnco_tpu.kernels.sa_finite import SweepConfigFW
from tnco_tpu.kernels.sa_fullsweep import uniform_log2_dim
from tnco_tpu.kernels.sa_infinite import SweepConfig
from tnco_tpu.ops import bitops as jbit
from tnco_tpu.testing.utils import generate_random_tensors
from tnco_tpu.utils.tn import get_random_contraction_path
from tnco_tpu_torch.convert import (batch_from_numpy, batch_fw_from_numpy,
                                    batch_fw_to_numpy, batch_to_numpy)
from tnco_tpu_torch.ctree import ContractionTree as TContractionTree
from tnco_tpu_torch.kernels import sa_multiwalk as tsmw
from tnco_tpu_torch.kernels import sa_walks as tsw
from tnco_tpu_torch.kernels.sa_finite import SweepConfigFW as TConfigFW
from tnco_tpu_torch.kernels.sa_infinite import SweepConfig as TConfig
from tnco_tpu_torch.ops import costs as tcosts
from test_torch_batched import min_ties
from test_torch_walks import reslice_ties
from torch_reference_native import reference_native  # noqa: F401

TOTAL_ATOL = 1e-5
B = 3
MAX_WIDTH = 5.0
_TOTALS = ('log2_total', 'min_log2_total')
BETAS = (0.0, 0.5, 2.0, 5.0, 10.0, 30.0)


def network(net, seed):
    kw = dict(n_tensors=14, n_extra_edges=8, n_output_inds=1)
    if net == 'dim2':
        return generate_random_tensors(seed, min_dim=2, max_dim=2,
                                       use_mixed_labels=False, **kw)
    ts, out, dims = generate_random_tensors(seed, min_dim=2, max_dim=5,
                                            **kw)
    assert len(set(dims.values())) > 1
    return ts, out, dims


def both_trees(net, seed):
    """``B`` random paths on one network as JAX and port trees."""
    ts, out, dims = network(net, seed)
    order = tuple(dict.fromkeys(x for xs in ts for x in xs))
    trees, ttrees = [], []
    for r in range(B):
        (path,) = [p for p in get_random_contraction_path(
            ts, out, merge_paths=False, seed=seed + r) if p]
        kwt = dict(output_inds=out, check_shared_inds=True, inds_order=order)
        trees.append(ContractionTree(path, ts, dims, **kwt))
        ttrees.append(TContractionTree(path, ts, dims, **kwt))
    return trees, ttrees


def setup(net, seed, prob_kind='mh', fw=False, dtype=jnp.float32):
    """Both packages' trees on one random network; the JAX batch (FW
    with cap ``MAX_WIDTH``), both configs, the padded log2 dims
    ``[W, 32]`` and ``uniform_log2``; also the port's trees."""
    trees, ttrees = both_trees(net, seed)
    t = trees[0]
    w = t.inds_array.shape[1]
    log2d = np.array(jbit.pad_log2_dims(t.log2_dims_array, w, dtype))
    seeds = [seed + r for r in range(B)]
    np_dtype = np.dtype(dtype)
    if fw:
        batch = jsfb.init_batch_fw(trees, seeds, MAX_WIDTH, log2d,
                                   dtype=np_dtype)
        flags = dict(n_leaves=t.n_leaves, n_lanes=w, prob_kind=prob_kind)
        cfg, tcfg = SweepConfigFW(**flags), TConfigFW(**flags)
    else:
        batch = jsb.init_batch(trees, seeds, log2d, dtype=np_dtype)
        flags = dict(n_leaves=t.n_leaves, n_lanes=w, prob_kind=prob_kind)
        cfg, tcfg = SweepConfig(**flags), TConfig(**flags)
    return (batch, cfg, tcfg, log2d.reshape(w, 32),
            uniform_log2_dim(t.log2_dims_array), ttrees)


def fields(batch):
    return {k: np.asarray(getattr(batch, k)) for k in batch.__slots__}


def port_fields(batch):
    """A port batch's fields in the JAX layout, as copies (the tie
    helpers write into them)."""
    conv = batch_fw_to_numpy if hasattr(batch, 'width') else batch_to_numpy
    return {k: v.copy() for k, v in conv(batch).items()}


def _t(x):
    return torch.from_numpy(np.array(x, order='C'))


def jax_draws(keys, cfg, p, dtype=jnp.float32, fw=False):
    """One iteration's JAX draws: ``(walks, multiwalk)`` dicts, the
    walks engine's ``[1, B, P]`` (and FW ``jitter [1, n_bits, B]``) and
    the multi-walk engine's ``[1, P, B]`` (FW ``jitter [1, n_bits,
    B]``, one reslice)."""
    _, leaf, rand_bit, u, rest = jsmw._draws(keys, cfg.n_leaves, p, dtype,
                                             5 if fw else 4)
    mw = {'leaf': _t(np.asarray(leaf, np.int32))[None],
          'rand_bit': _t(rand_bit)[None],
          'u': _t(u)[None]}
    wk = {k: v.transpose(1, 2).contiguous() for k, v in mw.items()}
    if fw:
        jitter = _t(jax.vmap(lambda k: jax.random.uniform(
            k, (cfg.n_lanes * 32,), dtype=dtype))(rest[0]).T)[None]
        wk['jitter'] = mw['jitter'] = jitter
    return wk, mw


def compare(ref, got, what, atol=TOTAL_ATOL, margins=None):
    """Every field but ``keys`` of ``ref`` (numpy dict) against ``got``
    (numpy dict): totals within ``atol``, the rest bitwise."""
    try:
        for k, v in ref.items():
            if k == 'keys':
                continue
            if k in _TOTALS:
                np.testing.assert_allclose(got[k], v, rtol=0, atol=atol,
                                           err_msg=f'{what}: {k}')
            else:
                np.testing.assert_array_equal(got[k], v,
                                              err_msg=f'{what}: {k}')
    except AssertionError as e:
        if margins is None:
            raise
        raise AssertionError(f'{e}\nSmallest decision margins: {margins()} '
                             f'(float bound {atol})') from None


def _margins(start, dr, beta, tlog2d, tcfg, pos, ul, fw=False):
    """The port's smallest accept margins of one iteration (round rule;
    'mh': ``|log2 u + beta (l_new - lt)|``, else ``|l_new - lt|``)."""
    S = tsw._pack_w(start.c0, start.c1, start.par, start.inds, start.lcc,
                    width=start.width if fw else None)
    nk = 2 if tlog2d.dtype == torch.float64 else 1
    lt = tsw._lt_from_S(S, tcfg.n_lanes, nk, tcfg.n_leaves, tlog2d.dtype)
    _, ev = tsw._propose_walks(S, pos.T.contiguous(), dr['leaf'][0],
                               dr['rand_bit'][0], tcfg, tlog2d, ul,
                               tlog2d.dtype,
                               slices_wb=start.slices if fw else None,
                               with_width=fw)
    l_new = tcosts.new_total_log2(lt[:, None], ev['l_a'], ev['l_b'],
                                  ev['ln_a'], ev['ln_b'])
    m = (l_new - lt[:, None]).abs()
    if tcfg.prob_kind == 'mh':
        m = (torch.log2(dr['u'][0]) + beta * (l_new - lt[:, None])).abs()
    return sorted(float(x) for x in m.reshape(-1))[:3]


# on_block, accept_rule, prob_kind, P, net: every on_block value, each
# accept_rule at P=1 and P=6, every prob_kind of the walks engine.
IM_CASES = [
    ('advance', 'round', 'mh', 6, 'dim2'),
    ('restart', 'round', 'mh', 6, 'dim2'),
    ('dedup', 'round', 'mh', 6, 'mixed'),
    ('advance', 'chained', 'mh', 1, 'dim2'),
    ('advance', 'chained', 'mh', 6, 'mixed'),
    ('dedup', 'chained', 'greedy', 6, 'dim2'),
    ('advance', 'round', 'greedy', 6, 'mixed'),
    ('restart', 'round', 'base', 6, 'dim2'),
    ('advance', 'round', 'mh_local', 6, 'mixed'),
    ('dedup', 'chained', 'mh_local', 6, 'dim2'),
]


@pytest.mark.parametrize('on_block,accept_rule,prob_kind,p,net', IM_CASES)
def test_run_walks_matches_jax_and_multiwalk(random_seed, on_block,
                                             accept_rule, prob_kind, p, net):
    """The port's IM ``run_walks`` against JAX's, one iteration at a time
    over six betas, and against the port's ``run_multiwalk`` on the same
    draws (bitwise, totals included; 'mh_local' is a walks-only rule)."""
    batch, cfg, tcfg, log2d_w32, ul, _ = setup(net, random_seed % 1000,
                                               prob_kind)
    tlog2d = _t(log2d_w32)
    opts = dict(on_block=on_block, accept_rule=accept_rule)
    pos = jnp.full((p, B), -1, jnp.int32)
    applied = moved = 0
    for it, beta in enumerate(BETAS):
        wk, mw = jax_draws(batch.keys, cfg, p)
        start = batch_from_numpy(fields(batch), 'cpu')
        pos_t = _t(pos)
        ref, mref = jsw.run_walks(batch, jnp.asarray([beta], jnp.float32),
                                  jnp.asarray(log2d_w32), cfg, pos,
                                  uniform_log2=ul, **opts)
        got, mgot = tsw.run_walks(start, [beta], tlog2d, tcfg, pos_t,
                                  uniform_log2=ul, draws=wk, device='cpu',
                                  **opts)
        what = f'{opts} {prob_kind} P={p} iteration {it} (beta={beta})'
        g = port_fields(got)
        min_ties(batch, ref, g)
        compare(fields(ref), g, what,
                margins=lambda: _margins(start, wk, beta, tlog2d, tcfg,
                                         pos_t, ul))
        np.testing.assert_array_equal(mgot['pos'].numpy(),
                                      np.asarray(mref['pos']), err_msg=what)
        assert mgot['moves'] == int(mref['moves']) == B * p
        assert int(mgot['applied']) == int(mref['applied']), what
        if prob_kind != 'mh_local':
            alt, malt = tsmw.run_multiwalk(start, [beta], tlog2d, tcfg, p,
                                           pos_t, uniform_log2=ul, draws=mw,
                                           **opts)
            compare(batch_to_numpy(got), batch_to_numpy(alt),
                    what + ' vs run_multiwalk', atol=0)
            assert torch.equal(malt['pos'], mgot['pos'])
            assert int(malt['applied']) == int(mgot['applied'])
        if on_block != 'advance':
            # The schedule at work: positions other than 'advance' gives.
            _, madv = tsw.run_walks(start, [beta], tlog2d, tcfg, pos_t,
                                    uniform_log2=ul, draws=wk, device='cpu',
                                    accept_rule=accept_rule)
            moved += int((madv['pos'] != mgot['pos']).sum())
        applied += int(mref['applied'])
        batch, pos = ref, mref['pos']
    assert applied > 0
    assert moved > 0 or on_block == 'advance'


def test_chained_single_walk_equals_round(random_seed):
    """P=1: the running total is the pre-round total, so 'chained' and
    'round' give one trajectory (``tests/test_sa_walks.py``'s rule) on
    the port's engine too."""
    _, _, tcfg, log2d_w32, ul, ttrees = setup('dim2', random_seed % 1000)
    from tnco_tpu_torch.kernels import sa_batched as tsb
    batch = tsb.init_batch(ttrees, [1, 2, 3], log2d_w32.reshape(-1),
                           device='cpu')
    outs = []
    for rule in ('round', 'chained'):
        gen = torch.Generator().manual_seed(random_seed)
        out, m = tsw.run_walks(batch, np.linspace(0, 10, 20), _t(log2d_w32),
                               tcfg, torch.full((1, B), -1,
                                                dtype=torch.int32),
                               uniform_log2=ul, accept_rule=rule,
                               generator=gen, device='cpu')
        outs.append((batch_to_numpy(out), int(m['applied'])))
    assert outs[0][1] == outs[1][1] > 0
    for k, v in outs[0][0].items():
        np.testing.assert_array_equal(outs[1][0][k], v, err_msg=k)


@pytest.mark.parametrize('fw', [False, True])
def test_pairwise_claim_matches_jax(random_seed, fw):
    """``claim='pairwise'`` (one pass, no walk loop) against JAX's, IM and
    FW, one iteration at a time; its kept walks are pairwise disjoint."""
    batch, cfg, tcfg, log2d_w32, ul, _ = setup('dim2', random_seed % 1000,
                                               fw=fw)
    tlog2d = _t(log2d_w32)
    w = cfg.n_lanes
    p = 6
    pos = jnp.full((p, B), -1, jnp.int32)
    applied = 0
    for it, beta in enumerate(BETAS):
        wk, _ = jax_draws(batch.keys, cfg, p, fw=fw)
        pos_t = _t(pos)
        what = f'fw={fw} iteration {it}'
        if fw:
            reslice = it % 2 == 0
            start = batch_fw_from_numpy(fields(batch), 'cpu')
            ref, mref = jsw.run_walks_fw(
                batch, jnp.asarray([beta], jnp.float32),
                jnp.asarray([reslice]), jnp.float32(MAX_WIDTH),
                jnp.asarray(log2d_w32), jnp.zeros(w, jnp.uint32), cfg, pos,
                claim='pairwise', uniform_log2=ul)
            got, mgot = tsw.run_walks_fw(
                start, [beta], [reslice], MAX_WIDTH, tlog2d,
                torch.zeros(w, dtype=torch.int32), tcfg, pos_t,
                claim='pairwise', uniform_log2=ul, draws=wk, device='cpu')
            g = port_fields(got)
            reslice_ties(batch, ref, g, jnp.asarray(log2d_w32), ul,
                         cfg.n_leaves)
        else:
            start = batch_from_numpy(fields(batch), 'cpu')
            ref, mref = jsw.run_walks(batch, jnp.asarray([beta], jnp.float32),
                                      jnp.asarray(log2d_w32), cfg, pos,
                                      claim='pairwise', uniform_log2=ul)
            got, mgot = tsw.run_walks(start, [beta], tlog2d, tcfg, pos_t,
                                      claim='pairwise', uniform_log2=ul,
                                      draws=wk, device='cpu')
            g = port_fields(got)
        min_ties(batch, ref, g)
        compare(fields(ref), g, what,
                margins=lambda: _margins(start, wk, beta, tlog2d, tcfg,
                                         pos_t, ul, fw))
        np.testing.assert_array_equal(mgot['pos'].numpy(),
                                      np.asarray(mref['pos']), err_msg=what)
        assert int(mgot['applied']) == int(mref['applied']), what
        applied += int(mref['applied'])
        batch, pos = ref, mref['pos']
    assert applied > 0


def test_claims_on_one_proposal_set(random_seed):
    """The claims on one set of proposals: the pairwise claim keeps a
    subset of the sequential one, both disjoint, equal to JAX's."""
    batch, cfg, tcfg, log2d_w32, ul, _ = setup('dim2', random_seed % 1000)
    p = 8
    w = cfg.n_lanes
    S = jsw._pack_w(batch.c0, batch.c1, batch.par, batch.inds, batch.lcc)
    St = _t(np.asarray(S).view(np.int32))
    wk, _ = jax_draws(batch.keys, cfg, p)
    pos = jnp.full((B, p), -1, jnp.int32)
    _, ev = jsw._propose_walks(S, pos, jnp.asarray(wk['leaf'][0].numpy()),
                               jnp.asarray(wk['rand_bit'][0].numpy()), cfg,
                               jnp.asarray(log2d_w32), ul, jnp.float32,
                               None, None, None)
    _, ev_t = tsw._propose_walks(St, _t(pos), wk['leaf'][0],
                                 wk['rand_bit'][0], tcfg, _t(log2d_w32), ul,
                                 torch.float32)
    acc = np.asarray(ev['b']) != -1
    acc_t = torch.from_numpy(acc)
    seq = tsw._claim_sequential(acc_t, ev_t)
    pair = tsw._claim_pairwise(acc_t, ev_t)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(
        jsw._claim_sequential(jnp.asarray(acc), ev)))
    np.testing.assert_array_equal(pair.numpy(), np.asarray(
        jsw._claim_pairwise(jnp.asarray(acc), ev)))
    assert bool((seq | ~pair).all())
    confl = tsmw._conflicts(ev_t)
    for keep in (seq, pair):
        both = keep[:, :, None] & keep[:, None, :] & confl
        assert not (both & ~torch.eye(p, dtype=torch.bool)[None]).any()
    assert w >= 1


@pytest.mark.parametrize('on_block,accept_rule', [('dedup', 'round'),
                                                  ('advance', 'chained'),
                                                  ('restart', 'chained')])
def test_run_walks_fw_variants_match_jax(random_seed, on_block, accept_rule):
    """``run_walks_fw`` with 'dedup' and 'chained' against JAX's, one
    iteration at a time with reslices, and against the port's
    ``run_multiwalk_fw`` on the same draws (bitwise)."""
    batch, cfg, tcfg, log2d_w32, ul, _ = setup('dim2', random_seed % 1000,
                                               fw=True)
    tlog2d = _t(log2d_w32)
    w = cfg.n_lanes
    p = 6
    opts = dict(on_block=on_block, accept_rule=accept_rule)
    pos = jnp.full((p, B), -1, jnp.int32)
    applied = 0
    for it, beta in enumerate(BETAS):
        reslice = it % 2 == 0
        wk, mw = jax_draws(batch.keys, cfg, p, fw=True)
        start = batch_fw_from_numpy(fields(batch), 'cpu')
        pos_t = _t(pos)
        ref, mref = jsw.run_walks_fw(
            batch, jnp.asarray([beta], jnp.float32), jnp.asarray([reslice]),
            jnp.float32(MAX_WIDTH), jnp.asarray(log2d_w32),
            jnp.zeros(w, jnp.uint32), cfg, pos, uniform_log2=ul, **opts)
        args = ([beta], [reslice], MAX_WIDTH, tlog2d,
                torch.zeros(w, dtype=torch.int32), tcfg)
        got, mgot = tsw.run_walks_fw(start, *args, pos_t, uniform_log2=ul,
                                     draws=wk, device='cpu', **opts)
        what = f'{opts} iteration {it} (beta={beta}, reslice={reslice})'
        g = port_fields(got)
        reslice_ties(batch, ref, g, jnp.asarray(log2d_w32), ul, cfg.n_leaves)
        min_ties(batch, ref, g)
        compare(fields(ref), g, what,
                margins=lambda: _margins(start, wk, beta, tlog2d, tcfg,
                                         pos_t, ul, True))
        np.testing.assert_array_equal(mgot['pos'].numpy(),
                                      np.asarray(mref['pos']), err_msg=what)
        assert int(mgot['applied']) == int(mref['applied']), what
        mwd = dict(mw, jitter=mw['jitter'][:1 if reslice else 0])
        alt, malt = tsmw.run_multiwalk_fw(start, *args, p, pos_t,
                                          uniform_log2=ul, draws=mwd, **opts)
        compare(batch_fw_to_numpy(got), batch_fw_to_numpy(alt),
                what + ' vs run_multiwalk_fw', atol=0)
        assert torch.equal(malt['pos'], mgot['pos'])
        applied += int(mref['applied'])
        batch, pos = ref, mref['pos']
    assert applied > 0


@pytest.mark.parametrize('fw', [False, True])
def test_walk_chunk_is_bitwise_and_checked(random_seed, fw):
    """``walk_chunk`` in ``run_multiwalk(_fw)`` gives the ``walk_chunk=0``
    result bitwise for every divisor of P (and for chunks of P or more),
    and raises JAX's ``ValueError``s otherwise."""
    batch, cfg, tcfg, log2d_w32, ul, _ = setup('mixed', random_seed % 1000,
                                               fw=fw)
    tlog2d = _t(log2d_w32)
    w = cfg.n_lanes
    p = 6
    gen = torch.Generator().manual_seed(random_seed)
    k = 5
    if fw:
        start = batch_fw_from_numpy(fields(batch), 'cpu')
        mask = [True, False, True, False, False]
        draws = tsmw.draw_chunk_fw(gen, cfg.n_leaves, k, p, B, 32 * w, 2)

        def run(chunk):
            return batch_fw_to_numpy(tsmw.run_multiwalk_fw(
                start, np.linspace(0, 6, k), mask, MAX_WIDTH, tlog2d,
                torch.zeros(w, dtype=torch.int32), tcfg, p,
                torch.full((p, B), -1, dtype=torch.int32), uniform_log2=ul,
                accept_rule='chained', on_block='dedup', walk_chunk=chunk,
                draws=draws)[0])
    else:
        start = batch_from_numpy(fields(batch), 'cpu')
        draws = tsmw.draw_chunk(gen, cfg.n_leaves, k, p, B)

        def run(chunk):
            return batch_to_numpy(tsmw.run_multiwalk(
                start, np.linspace(0, 6, k), tlog2d, tcfg, p,
                torch.full((p, B), -1, dtype=torch.int32), uniform_log2=ul,
                on_block='restart', walk_chunk=chunk, draws=draws)[0])

    want = run(0)
    for chunk in (1, 2, 3, 6, 7):
        got = run(chunk)
        for name, v in want.items():
            np.testing.assert_array_equal(got[name], v,
                                          err_msg=f'chunk {chunk}: {name}')
    for chunk, msg in ((-1, 'must be >= 0'), (4, 'must divide n_walks')):
        with pytest.raises(ValueError, match=msg):
            run(chunk)
        with pytest.raises(ValueError, match=msg):
            jsmw._eval_chunked(lambda *a: {}, jnp.zeros((p, B)),
                               jnp.zeros((p, B)), jnp.zeros((p, B)), chunk)


def test_runner_option_rules(random_seed):
    """The runners take and refuse what JAX's do, with JAX's errors
    (``tests/test_sa_walks.py:520-540`` is the model)."""
    from tnco_tpu.parallel.replicas import ReplicaRunner as JRunner
    from tnco_tpu_torch.optimize.finite_width import SimpleCostModel
    from tnco_tpu_torch.parallel import ReplicaRunner, ReplicaRunnerFW
    jtrees, ttrees = both_trees('dim2', random_seed % 1000)
    seeds = [1, 2, 3]
    kwfw = dict(cmodel=SimpleCostModel(max_width=MAX_WIDTH), device='cpu')
    refused = [
        (dict(engine='batched', accept_rule='chained'), 'accept_rule'),
        (dict(engine='vmapped', on_block='restart'), 'on_block'),
        (dict(engine='walker', on_block='dedup'), "engine='walker'"),
        (dict(engine='walks', on_block='sideways'), 'on_block must be'),
        (dict(engine='multiwalk', accept_rule='serial'),
         "accept_rule must be 'round' or 'chained'"),
        (dict(engine='multiwalk', prob_kind='mh_local'), 'mh_local'),
        (dict(engine='batched', prob_kind='mh_local'), 'mh_local'),
    ]
    for kw, msg in refused:
        for make in (lambda: ReplicaRunner(ttrees, seeds, device='cpu', **kw),
                     lambda: ReplicaRunnerFW(ttrees, seeds, **kwfw, **kw),
                     lambda: JRunner(jtrees, seeds, **kw)):
            with pytest.raises(ValueError, match=msg):
                make()
    for chunk in (-1, 3):
        with pytest.raises(ValueError, match='walk_chunk'):
            ReplicaRunner(ttrees, seeds, engine='multiwalk', n_walks=4,
                          walk_chunk=chunk, device='cpu')
    for kw in (dict(on_block='restart'), dict(on_block='dedup'),
               dict(accept_rule='chained'), dict(prob_kind='mh_local'),
               dict(prob_kind='greedy'), dict(prob_kind='base')):
        for runner in (ReplicaRunner(ttrees, seeds, engine='walks',
                                     n_walks=4, device='cpu', **kw),
                       ReplicaRunnerFW(ttrees, seeds, engine='walks',
                                       n_walks=4, **kwfw, **kw)):
            assert (runner.on_block, runner.accept_rule,
                    runner.cfg.prob_kind) == (
                kw.get('on_block', 'advance'),
                kw.get('accept_rule', 'round'), kw.get('prob_kind', 'mh'))
            runner.run(np.linspace(0.0, 5.0, 6), chunk_size=3)
            assert runner.applied_done > 0
            assert runner.ctree(0).is_valid(check_shared_inds=True)
    im = ReplicaRunner(ttrees, seeds, engine='walks', device='cpu')
    assert im.n_walks == 32
    mw = ReplicaRunner(ttrees, seeds, engine='multiwalk', n_walks=6,
                       walk_chunk=3, on_block='dedup', device='cpu')
    assert mw.walk_chunk == 3
    mw.run(np.linspace(0.0, 5.0, 4))


def _audit(runner, fw=False):
    """Every replica's best tree is valid and its exact cost is the
    device's min total (within the float bound), its widths within the
    cap (finite width)."""
    import math
    mins = runner.log2_min_totals()
    for r in range(runner.n_replicas):
        tree = runner.min_ctree(r)
        assert tree.is_valid(check_shared_inds=True)
        if fw:
            continue
        exact = math.log2(int(tree.total_cost_exact()))
        assert abs(exact - float(mins[r])) <= 1e-4, (r, exact, mins[r])


def test_runner_and_optimizer_walks_end_to_end(random_seed):
    """``ReplicaRunner(engine='walks')`` and ``Optimizer(engine='walks')``
    on the CPU: walks, applied moves, audited best trees."""
    from tnco_tpu_torch.app import Optimizer, load_tn
    from tnco_tpu_torch.app.tn import Tensor, TensorNetwork
    from tnco_tpu_torch.parallel import ReplicaRunner
    *_, ttrees = setup('mixed', random_seed % 1000)
    runner = ReplicaRunner(ttrees, [4, 5, 6], engine='walks', n_walks=5,
                           on_block='dedup', accept_rule='chained',
                           device='cpu')
    seen = []
    info = runner.run(np.linspace(0.0, 8.0, 10), chunk_size=4,
                      callback=seen.append)
    assert runner.sweeps_done == 12 and len(seen) == 3
    assert info['moves'] == 12 * 5 * B and info['applied'] > 0
    assert tuple(runner._mw_pos.shape) == (5, B)
    _audit(runner)
    runner.run(np.linspace(0.0, 8.0, 4), exchange_every=1, chunk_size=2)
    _audit(runner)

    ts, out, dims = network('dim2', random_seed % 1000)
    tn = TensorNetwork([Tensor(xs, tuple(dims[x] for x in xs))
                        for xs in ts], output_inds=out)
    _, res = Optimizer(seed=random_seed % 1000, device='cpu',
                       engine='walks').optimize(tn, betas=(0, 10),
                                                n_steps=12, n_runs=3, fuse=0)
    loaded = load_tn(tn, fuse=0)
    assert res == sorted(res) and len(res) == 3
    for r in res:
        tree = TContractionTree(r.path, loaded.ts_inds, loaded.dims,
                                output_inds=loaded.output_inds)
        assert tree.is_valid(check_shared_inds=True)
        assert r.cost == Decimal(int(tree.total_cost_exact()))


def test_device_rule():
    """``run_walks`` follows the device rule: ``device=None`` means the
    card, and without one it raises and asks for ``device='cpu'``."""
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    batch, cfg, tcfg, log2d_w32, ul, _ = setup('dim2', 5)
    start = batch_from_numpy(fields(batch), 'cpu')
    pos = torch.full((2, B), -1, dtype=torch.int32)
    gen = torch.Generator()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsw.run_walks(start, [1.0], _t(log2d_w32), tcfg, pos, generator=gen)
    with pytest.raises(ValueError, match='draws= or generator='):
        tsw.run_walks(start, [1.0], _t(log2d_w32), tcfg, pos, device='cpu')
    with pytest.raises(ValueError, match='claim'):
        tsw.run_walks(start, [1.0], _t(log2d_w32), tcfg, pos, claim='any',
                      generator=gen, device='cpu')


@pytest.mark.cuda
def test_card_walk_variants_match_cpu(random_seed):
    """One iteration of each variant on the card against the CPU from one
    state and the same draws: integer and bit state bitwise, totals
    within the float bound."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    for fw in (False, True):
        batch, cfg, tcfg, log2d_w32, ul, _ = setup(
            'dim2', random_seed % 1000, fw=fw)
        w = cfg.n_lanes
        p = 6
        wk, _ = jax_draws(batch.keys, cfg, p, fw=fw)
        for kw in (dict(on_block='restart'), dict(on_block='dedup'),
                   dict(accept_rule='chained'), dict(claim='pairwise')):
            outs = []
            for dev in ('cpu', 'cuda'):
                pos = torch.full((p, B), -1, dtype=torch.int32, device=dev)
                dr = {k: v.to(dev) for k, v in wk.items()}
                if fw:
                    out, _ = tsw.run_walks_fw(
                        batch_fw_from_numpy(fields(batch), dev), [2.0],
                        [True], MAX_WIDTH, _t(log2d_w32).to(dev),
                        torch.zeros(w, dtype=torch.int32, device=dev), tcfg,
                        pos, uniform_log2=ul, draws=dr, device=dev, **kw)
                    outs.append(batch_fw_to_numpy(out))
                else:
                    out, _ = tsw.run_walks(
                        batch_from_numpy(fields(batch), dev), [2.0],
                        _t(log2d_w32).to(dev), tcfg, pos, uniform_log2=ul,
                        draws=dr, device=dev, **kw)
                    outs.append(batch_to_numpy(out))
            compare(outs[0], outs[1], f'fw={fw} {kw} card vs cpu')

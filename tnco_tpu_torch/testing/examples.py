"""The three flows of ``examples/`` through the port, with their audits
(test and smoke helpers).

:func:`base_optimization`, :func:`optimization` and :func:`sampling` run
``examples/base_optimization.py``, ``examples/optimization.py`` and
``examples/sampling.py`` at their own sizes and seeds, with ``device=``
passed to every entry point (the port raises without CUDA unless the
caller passes ``device='cpu'``), and return what the examples print.
Each ``audit_*`` raises ``AssertionError`` naming what failed: valid
trees, exact bigint costs, widths within the cap after slicing, and the
sampled amplitudes and frequencies against a dense statevector.
"""

import math
import pickle

import numpy as np

from random import Random

from tnco_tpu_torch.app import (Optimizer as AppOptimizer, Tensor,
                                TensorNetwork, load_tn)
from tnco_tpu_torch.app.circuit import Sampler
from tnco_tpu_torch.ctree import ContractionTree, traverse_tree
from tnco_tpu_torch.optimize.finite_width import (
    Optimizer as FWOptimizer, SimpleCostModel as FWCostModel)
from tnco_tpu_torch.optimize.infinite_memory import (Optimizer,
                                                     SimpleCostModel)
from tnco_tpu_torch.optimize.prob import MetropolisHastings
from tnco_tpu_torch.testing.sampling import (recorded_amplitudes,
                                             tv_distance,
                                             visited_probability_error)
from tnco_tpu_torch.testing.utils import generate_random_tensors
from tnco_tpu_torch.utils.tn import get_connected_components

__all__ = ['CHAIN', 'lattice_rows', 'sampling_circuit', 'base_optimization',
           'optimization', 'sampling', 'audit_base_optimization',
           'audit_result', 'audit_optimization', 'audit_sampling',
           'RANDOM_SHAPES', 'random_networks', 'audit_random_networks',
           'AMPLITUDE_ATOL', 'TV_MAX']

# base_optimization.py's chain: (path, ts_inds, dims).
CHAIN = ([(0, 1), (0, 1), (0, 1)],
         [['i', 'j'], ['j', 'k'], ['k', 'l'], ['l', 'm']],
         {'i': 2, 'j': 4, 'k': 8, 'l': 4, 'm': 2})
# Every amplitude the sampling loop contracts, against the statevector's;
# and the total-variation distance of the sampled frequencies (200 and
# 100 samples over 16 outcomes; about 0.11 and 0.16 expected).
AMPLITUDE_ATOL = 1e-10
TV_MAX = 0.35
SAMPLING_QUBITS = (0, 1, 2, 3)
# The random networks of the JAX package's core, contraction and utils
# tests (``generate_random_tensors`` keyword arguments), one seed each;
# optimized with and without a cap of RANDOM_MAX_WIDTH.
RANDOM_SHAPES = (
    dict(n_output_inds=2),
    dict(n_output_inds=2, n_hyper_edges=2, n_hyper_output_inds=1),
    dict(min_n_tensors=6, n_output_inds=1),
    dict(min_n_tensors=6, use_mixed_labels=False),
    dict(min_n_tensors=8, max_n_tensors=14, n_ccs=2),
    dict(n_ccs=3, n_tensors=12, n_output_inds=1),
    dict(n_tensors=6, min_dim=2, max_dim=3, use_mixed_labels=False),
    dict(n_ccs=1, n_tensors=6, n_output_inds=2, n_hyper_edges=1, min_dim=2,
         max_dim=3),
)
RANDOM_MAX_WIDTH = 3.0


def lattice_rows(n: int = 4):
    """optimization.py's n x n square lattice as index-map rows."""
    rows = []
    for r in range(n):
        for c in range(n):
            if c + 1 < n:
                rows.append((2, f't{r}{c}', f't{r}{c + 1}'))
            if r + 1 < n:
                rows.append((2, f't{r}{c}', f't{r + 1}{c}'))
    return rows


def sampling_circuit():
    """sampling.py's H-CX ladder with T phases on 4 qubits."""
    h = np.array([[1, 1], [1, -1]]) / math.sqrt(2)
    cx = np.eye(4)[[0, 1, 3, 2]]
    t = np.diag([1, np.exp(1j * math.pi / 4)])
    circuit = [(h, (q,)) for q in range(4)]
    for q in range(3):
        circuit.append((cx, (q, q + 1)))
        circuit.append((t, (q + 1,)))
    return circuit


def base_optimization(device):
    """The tree, its width and exact cost; 100 IM and 100 FW (max_width
    4, slices every 10) updates on a linear beta ramp; a pickled copy of
    the IM optimizer."""
    path, ts_inds, dims = CHAIN
    ctree = ContractionTree(path, ts_inds, dims, check_shared_inds=True)
    opt = Optimizer(ctree, SimpleCostModel(), seed=7, device=device)
    prob = MetropolisHastings()
    for step in range(100):
        prob.beta = step
        opt.update(prob)
    fw = FWOptimizer(ctree, FWCostModel(max_width=4.0), seed=7,
                     device=device)
    for step in range(100):
        prob.beta = step
        fw.update(prob, update_slices=(step % 10 == 0))
    clone = pickle.loads(pickle.dumps(opt))
    return dict(ctree=ctree, max_width=ctree.max_width(),
                cost=ctree.total_cost_exact(), opt=opt, fw=fw, clone=clone)


def _component_costs(tree, cmodel, slices, ts_inds):
    """``({component: exact cost}, nodes)`` of ``tree`` over the connected
    components of ``ts_inds``: the contractions inside each component,
    under the slices of its own indices, and every node but the outer
    products that merge components (the app's cost leaves those out and
    slices each component apart, as the JAX package's does)."""
    comp_of = {x: k
               for k, cc in enumerate(get_connected_components(ts_inds))
               for t in cc for x in ts_inds[t]}
    own = {}
    for x in slices:
        own.setdefault(comp_of[x], set()).add(x)
    nodes, inds, dims = tree.nodes, tree.inds, tree.dims
    key, costs, inner = {}, {}, []

    def visit(pos):
        node = nodes[pos]
        if node.is_leaf():
            key[pos] = comp_of[next(iter(inds[pos]))]
            inner.append(pos)
            return
        a, b = (key[c] for c in node.children)
        key[pos] = a if a == b else -1
        if a == b != -1:
            inner.append(pos)
            costs[a] = costs.get(a, 0) + cmodel.contraction_cost(
                inds[node.children[0]], inds[node.children[1]], inds[pos],
                dims, frozenset(own.get(a, ())))

    traverse_tree(tree, visit)
    return costs, inner


def audit_base_optimization(out):
    """Valid optimizers and trees; exact min costs; the FW min tree within
    its cap after its slices; the pickled copy equal to the optimizer."""
    ctree, opt, fw = out['ctree'], out['opt'], out['fw']
    assert out['clone'] == opt, 'pickle round trip'
    assert out['clone'].prng_state == opt.prng_state, 'pickled prng_state'
    for o, name in ((opt, 'IM'), (fw, 'FW')):
        ok, msg = o.is_valid(return_message=True)
        assert ok, f'{name} optimizer: {msg}'
        assert o.min_ctree.is_valid(), f'{name} min tree'
    exact = opt.min_ctree.total_cost_exact()
    assert int(opt.min_total_cost) == exact <= out['cost'], (
        f'IM min cost {opt.min_total_cost} vs exact {exact}')
    slices = fw.min_slices
    cm = fw.cmodel
    width = cm.get_max_width([xs - slices for xs in fw.min_ctree.inds],
                             fw.min_ctree.dims)
    assert width <= cm.max_width + 1e-9, f'FW width {width}'
    cost = sum(_component_costs(fw.min_ctree, cm, slices,
                                CHAIN[1])[0].values())
    assert int(fw.min_total_cost) == cost, (
        f'FW min cost {fw.min_total_cost} vs exact {cost}')


def optimization(device):
    """``(tn, runs)``: the loaded lattice and each ``optimize`` call's
    ``(tn, results)`` by name: the app's default, ``max_width=3.0``,
    'multiwalk' and 'walks'."""
    rows = lattice_rows()
    tn = load_tn(rows, fuse=False)
    runs = {}
    kw = dict(betas=(0, 50), n_runs=64, fuse=False)
    runs['default'] = AppOptimizer(method='sa', seed=42,
                                   device=device).optimize(
                                       rows, n_steps=200, **kw)
    runs['max_width'] = AppOptimizer(method='sa', max_width=3.0, seed=42,
                                     device=device).optimize(
                                         rows, n_steps=200,
                                         update_slices=10, **kw)
    runs['multiwalk'] = AppOptimizer(method='sa', seed=42, device=device,
                                     engine='multiwalk').optimize(
                                         rows, n_steps=400, **kw)
    runs['walks'] = AppOptimizer(method='sa', seed=42, device=device,
                                 engine='walks', n_walks=8).optimize(
                                     rows, n_steps=400, **kw)
    return tn, runs


def audit_result(res, tn, max_width=None):
    """A result's path builds a valid tree of ``tn`` whose exact cost
    (with the result's slices) is the result's cost, component by
    component (``disconnected_costs``), every width inside the components
    within ``max_width`` after the slices."""
    tree = ContractionTree(res.path, tn.ts_inds, tn.dims,
                           output_inds=tn.output_inds)
    ok, msg = tree.is_valid(return_message=True)
    assert ok, f'invalid path: {msg}'
    slices = frozenset(getattr(res, 'slices', ()))
    cm = FWCostModel(max_width=math.inf if max_width is None else max_width)
    costs, inner = _component_costs(tree, cm, slices, tn.ts_inds)
    got = sorted(c for c in map(int, res.disconnected_costs) if c)
    assert got == sorted(c for c in costs.values() if c), (
        f'component costs {got} != exact {sorted(costs.values())}')
    assert int(res.cost) == sum(costs.values()), (
        f'cost {res.cost} != exact {sum(costs.values())}')
    if max_width is not None:
        width = cm.get_max_width([tree.inds[p] - slices for p in inner],
                                 tree.dims)
        assert width <= max_width + 1e-9, f'width {width} > {max_width}'
    return tree


def audit_optimization(tn, runs):
    """Every result of every run audited; each run's results sorted by
    cost, one a run."""
    for name, (loaded, results) in runs.items():
        assert loaded.ts_inds == tn.ts_inds, f'{name}: network'
        assert len(results) == 64, f'{name}: {len(results)} results'
        costs = [r.cost for r in results]
        assert costs == sorted(costs), f'{name}: results not sorted'
        for res in results:
            audit_result(res, tn, 3.0 if name == 'max_width' else None)


def sampling(device):
    """The intermediate state (one optimization per gate prefix), 200
    samples from it with every contracted amplitude recorded, and 100
    samples under ``max_width=2.0``."""
    circuit = sampling_circuit()
    sampler = Sampler(seed=0, device=device)
    state = sampler.sample(circuit, return_intermediate_state_only=True,
                           fuse=3, betas=(0, 30), n_steps=30, n_runs=4)
    with recorded_amplitudes(state) as records:
        hits, qubits = sampler.sample(state, n_samples=200,
                                      qubit_order=SAMPLING_QUBITS,
                                      betas=(0, 30), n_steps=30)
    capped = Sampler(max_width=2.0, seed=0, device=device)
    hits_c, qubits_c = capped.sample(circuit, n_samples=100, fuse=3,
                                     qubit_order=SAMPLING_QUBITS,
                                     betas=(0, 30), n_steps=30, n_runs=4)
    return dict(circuit=circuit, state=state, records=records, hits=hits,
                qubits=qubits, hits_capped=hits_c, qubits_capped=qubits_c)


def audit_sampling(out):
    """Every amplitude the loop contracted within AMPLITUDE_ATOL of the
    statevector's; both samplers' frequencies within TV_MAX of its
    distribution, in the asked qubit order, normalized."""
    circuit = out['circuit']
    assert out['records'], 'no amplitude was contracted'
    err = visited_probability_error(out['records'], circuit,
                                    SAMPLING_QUBITS)
    assert err <= AMPLITUDE_ATOL, f'amplitudes off by {err}'
    for key in ('hits', 'hits_capped'):
        hits = out[key]
        qubits = out['qubits' if key == 'hits' else 'qubits_capped']
        assert tuple(qubits) == SAMPLING_QUBITS, f'{key}: order {qubits}'
        assert all(len(b) == 4 and set(b) <= {'0', '1'} for b in hits)
        assert abs(sum(hits.values()) - 1) < 1e-12, f'{key}: not normalized'
        tv = tv_distance(hits, SAMPLING_QUBITS, circuit)
        assert tv <= TV_MAX, f'{key}: total variation {tv}'
    return err


def random_networks(device, n_runs=4, n_steps=16):
    """Each network of RANDOM_SHAPES (seed = its position) through the
    app's ``Optimizer`` unfused, IM and with ``max_width``
    RANDOM_MAX_WIDTH (reslice every 4 sweeps): ``[(net, fw, tn,
    results)]``, ``net`` the generator's ``(ts_inds, output_inds,
    dims)``."""
    out = []
    for seed, kw in enumerate(RANDOM_SHAPES):
        net = generate_random_tensors(Random(seed), **kw)
        ts_inds, output_inds, dims = net
        tensors = [Tensor(tuple(xs), tuple(dims[x] for x in xs))
                   for xs in ts_inds]
        for fw in (False, True):
            opt = AppOptimizer(max_width=RANDOM_MAX_WIDTH if fw else None,
                               seed=seed, device=device)
            extra = dict(update_slices=4) if fw else {}
            tn, results = opt.optimize(
                TensorNetwork(tensors, output_inds=output_inds),
                betas=(0, 20), n_steps=n_steps, n_runs=n_runs, fuse=0,
                **extra)
            out.append((net, fw, tn, results))
    return out


def audit_random_networks(runs):
    """Every result of every run audited on its network (the loaded
    network equal to the generator's); returns the number of results."""
    n = 0
    for (ts_inds, output_inds, dims), fw, tn, results in runs:
        assert [tuple(xs) for xs in tn.ts_inds] == [tuple(xs)
                                                    for xs in ts_inds]
        assert results, 'no result'
        for res in results:
            audit_result(res, tn, RANDOM_MAX_WIDTH if fw else None)
            n += 1
    return n

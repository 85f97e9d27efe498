"""Simulated-annealing driver with a finite width constraint (the port's
copy of ``tnco_tpu/app/finite_width/sa.py``; the replica batch runs on
the optimizer's torch device).

Reference behavior: tnco/app/finite_width/sa.py:109-289 — same replica fan
-out as the infinite-memory driver plus a slice set co-optimized with the
tree (reslice every ``update_slices`` sweeps) and per-component /
union slices in the results.
"""

from dataclasses import dataclass
from decimal import Decimal
import functools as fts
import itertools as its
import json
import operator as op
from sys import stderr
from time import perf_counter
from typing import Any

from tnco_tpu_torch.app.app import (BaseContractionResults, BaseOptimizer,
                                    JSONEncoder as BaseJSONEncoder)
from tnco_tpu_torch.bitset import Bitset
from tnco_tpu_torch.ctree import ContractionTree
from tnco_tpu_torch.ops import bitops
from tnco_tpu_torch.optimize.finite_width import SimpleCostModel
from tnco_tpu_torch.parallel.replicas import ReplicaRunnerFW
import tnco_tpu_torch.utils.tn as tn_utils

__all__ = ['Optimizer', 'ContractionResults']


class JSONEncoder(BaseJSONEncoder):

    def default(self, obj) -> Any:
        match obj:
            case frozenset():
                return tuple(obj)
            case ContractionResults():
                return dict(**BaseJSONEncoder().default(obj),
                            disconnected_paths=obj.disconnected_paths,
                            disconnected_slices=obj.disconnected_slices,
                            slices=obj.slices)
            case _ if hasattr(obj, 'to_json'):
                return obj.to_json()
            case _:
                return super().default(obj)


@dataclass(repr=False, frozen=True, eq=False)
class ContractionResults(BaseContractionResults):
    """Results incl. per-component and union slice sets.

    Reference: tnco/app/finite_width/sa.py:73-106.
    """

    disconnected_costs: list
    disconnected_paths: list
    disconnected_slices: list
    slices: frozenset

    def to_json(self) -> str:
        return json.dumps(self, cls=JSONEncoder)


def _exact_component_cost(ctree: ContractionTree, cmodel: SimpleCostModel,
                          slices) -> int:
    total = 0
    inds = list(ctree.inds)          # each node's labels decoded once
    dims = ctree.dims
    for pos, node in enumerate(ctree.nodes):
        if not node.is_leaf():
            total += cmodel.contraction_cost(inds[node.children[0]],
                                             inds[node.children[1]],
                                             inds[pos], dims, slices)
    return total


class Optimizer(BaseOptimizer):
    """SA optimizer enforcing a maximum post-slicing tensor width."""

    def optimize(self,
                 tn: Any,
                 betas,
                 n_steps: int | None = None,
                 n_runs: int = 1,
                 n_projs: int | None = None,
                 update_slices: int = 10,
                 timeout: float | None = None,
                 **load_tn_options) -> Any:
        """Optimizes ``tn`` with a width cap (reference
        finite_width/sa.py:116-151)."""
        tn = self._load_tn(tn, **load_tn_options)
        rng = self._rng
        betas = self._expand_betas(betas, n_steps)

        cmodel = SimpleCostModel(max_width=self.max_width,
                                 cost_type=self.cost_type,
                                 width_type=self.width_type,
                                 sparse_inds=tn.sparse_inds,
                                 n_projs=n_projs)

        seeds = rng.choices(range(2**32), k=n_runs)

        if self.verbose == 1:
            print("# Optimizing ...", file=stderr, flush=True, end='')

        run_paths = _build_run_paths(tn, seeds, self.n_jobs)
        n_components = len(run_paths[0]) if run_paths else 0
        components = tn_utils.get_connected_components(tn.ts_inds)

        per_run = [
            dict(disconnected_costs=[], disconnected_paths=[],
                 disconnected_slices=[], runtime_s=0.0)
            for _ in range(n_runs)
        ]

        for c in range(n_components):
            paths_c = [run_paths[r][c] for r in range(n_runs)]
            if not paths_c[0]:
                for r in range(n_runs):
                    per_run[r]['disconnected_costs'].append(0)
                    per_run[r]['disconnected_paths'].append([])
                    per_run[r]['disconnected_slices'].append(frozenset())
                continue

            order = tuple(
                dict.fromkeys(
                    its.chain.from_iterable(tn.ts_inds[t]
                                            for t in components[c])))
            ctrees = [
                ContractionTree(paths_c[r],
                                tn.ts_inds,
                                tn.dims,
                                output_inds=tn.output_inds,
                                check_shared_inds=True,
                                inds_order=order) for r in range(n_runs)
            ]

            t0 = perf_counter()
            runner = ReplicaRunnerFW(ctrees, seeds, cmodel=cmodel,
                                     prob_kind=None,
                                     engine=self.engine,
                                     n_walks=self.n_walks,
                                     dtype=bitops.device_dtype(
                                         self.cost_type),
                                     device=self.device)
            runner.run(betas, update_slices=update_slices, timeout=timeout)
            runtime = perf_counter() - t0

            for r in range(n_runs):
                best = runner.min_ctree(r)
                lanes = runner.min_slices_lanes(r)
                labels = frozenset(
                    order[p]
                    for p in Bitset.from_lanes(lanes,
                                               len(order)).positions())
                per_run[r]['disconnected_costs'].append(
                    Decimal(_exact_component_cost(best, cmodel, labels)))
                per_run[r]['disconnected_paths'].append(best.path())
                per_run[r]['disconnected_slices'].append(labels)
                per_run[r]['runtime_s'] += runtime

        results = []
        for r in range(n_runs):
            res = per_run[r]
            cost = Decimal(sum(res['disconnected_costs']))
            paths = res['disconnected_paths'] or [()] * len(tn)
            slices_list = res['disconnected_slices'] or \
                [frozenset()] * len(tn)
            full_path = tn_utils.merge_contraction_paths(len(tn), paths)
            results.append(
                ContractionResults(
                    cost=cost,
                    runtime_s=res['runtime_s'],
                    path=full_path,
                    disconnected_costs=res['disconnected_costs'],
                    disconnected_paths=paths,
                    disconnected_slices=slices_list,
                    slices=fts.reduce(op.or_, slices_list, frozenset())))

        if self.verbose == 1:
            print(" Done!", file=stderr, flush=True)

        return self._dump_results(tn, sorted(results))


def _build_run_paths(tn, seeds, n_jobs):
    """Per-run random initial paths (one list per connected component),
    from ``tnco_tpu/app/infinite_memory/sa.py:173-193``.

    ``n_jobs`` parallelizes the per-run greedy paths over processes when
    joblib is installed; without it the paths are built in this process.
    """
    def one(seed):
        return tn_utils.get_random_contraction_path(tn.ts_inds,
                                                    tn.output_inds,
                                                    merge_paths=False,
                                                    seed=seed)

    if n_jobs != 1 and len(seeds) >= 32:
        try:
            from joblib import delayed, Parallel as JoblibParallel
            return JoblibParallel(n_jobs=n_jobs, prefer='processes')(
                delayed(one)(seed) for seed in seeds)
        except ImportError:
            pass
    return [one(seed) for seed in seeds]

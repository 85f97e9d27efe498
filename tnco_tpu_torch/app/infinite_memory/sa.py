"""Simulated-annealing driver, infinite memory (the port's copy of
``tnco_tpu/app/infinite_memory/sa.py``; the replica batch runs on the
optimizer's torch device).

Reference behavior: tnco/app/infinite_memory/sa.py:93-257 — per-run random
initial paths per connected component, a linear beta ramp, per-run best
tree/cost, results merged across components and sorted by cost.
"""

from dataclasses import dataclass
from decimal import Decimal
import itertools as its
import json
from sys import stderr
from time import perf_counter
from typing import Any

from tnco_tpu_torch.app.app import (BaseContractionResults, BaseOptimizer,
                                    JSONEncoder as BaseJSONEncoder)
from tnco_tpu_torch.app.finite_width.sa import _build_run_paths
from tnco_tpu_torch.ctree import ContractionTree
from tnco_tpu_torch.ops import bitops
from tnco_tpu_torch.optimize.infinite_memory import SimpleCostModel
from tnco_tpu_torch.parallel.replicas import ReplicaRunner
import tnco_tpu_torch.utils.tn as tn_utils

__all__ = ['Optimizer', 'ContractionResults']


class JSONEncoder(BaseJSONEncoder):

    def default(self, obj) -> Any:
        match obj:
            case ContractionResults():
                return dict(**BaseJSONEncoder().default(obj),
                            disconnected_paths=obj.disconnected_paths)
            case _ if hasattr(obj, 'to_json'):
                return obj.to_json()
            case _:
                return super().default(obj)


@dataclass(repr=False, frozen=True, eq=False)
class ContractionResults(BaseContractionResults):
    """Per-run results incl. per-component costs/paths.

    Reference: tnco/app/infinite_memory/sa.py:63-91.
    """

    disconnected_costs: list
    disconnected_paths: list

    def to_json(self) -> str:
        return json.dumps(self, cls=JSONEncoder)


def _exact_component_cost(ctree: ContractionTree,
                          cmodel: SimpleCostModel) -> int:
    """Exact (bigint) total cost of a component tree under ``cmodel``."""
    if not cmodel.sparse_inds:
        return ctree.total_cost_exact()
    total = 0
    inds = list(ctree.inds)          # each node's labels decoded once
    dims = ctree.dims
    for pos, node in enumerate(ctree.nodes):
        if not node.is_leaf():
            total += cmodel.contraction_cost(inds[node.children[0]],
                                             inds[node.children[1]],
                                             inds[pos], dims)
    return total


class Optimizer(BaseOptimizer):
    """SA optimizer assuming infinite memory."""

    def optimize(self,
                 tn: Any,
                 betas,
                 n_steps: int | None = None,
                 n_runs: int = 1,
                 n_projs: int | None = None,
                 timeout: float | None = None,
                 **load_tn_options) -> Any:
        """Optimizes ``tn`` with ``n_runs`` replicas over the beta ramp.

        Args mirror the reference driver
        (tnco/app/infinite_memory/sa.py:100-133).
        """
        tn = self._load_tn(tn, **load_tn_options)
        rng = self._rng
        betas = self._expand_betas(betas, n_steps)

        cmodel = SimpleCostModel(cost_type=self.cost_type,
                                 sparse_inds=tn.sparse_inds,
                                 n_projs=n_projs)

        seeds = rng.choices(range(2**32), k=n_runs)

        if self.verbose == 1:
            print("# Optimizing ...", file=stderr, flush=True, end='')

        run_paths = _build_run_paths(tn, seeds, self.n_jobs)
        n_components = len(run_paths[0]) if run_paths else 0

        # Canonical per-component index order so replicas share bit layout.
        components = tn_utils.get_connected_components(tn.ts_inds)

        per_run = [
            dict(disconnected_costs=[], disconnected_paths=[], runtime_s=0.0)
            for _ in range(n_runs)
        ]

        for c in range(n_components):
            paths_c = [run_paths[r][c] for r in range(n_runs)]
            if not paths_c[0]:
                for r in range(n_runs):
                    per_run[r]['disconnected_costs'].append(0)
                    per_run[r]['disconnected_paths'].append([])
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
            runner = ReplicaRunner(ctrees, seeds,
                                   cmodel=cmodel,
                                   prob_kind=None,
                                   engine=self.engine,
                                   n_walks=self.n_walks,
                                   dtype=bitops.device_dtype(
                                       self.cost_type),
                                   device=self.device)
            runner.run(betas, timeout=timeout)
            runtime = perf_counter() - t0

            for r in range(n_runs):
                best = runner.min_ctree(r)
                per_run[r]['disconnected_costs'].append(
                    Decimal(_exact_component_cost(best, cmodel)))
                per_run[r]['disconnected_paths'].append(best.path())
                per_run[r]['runtime_s'] += runtime

        results = []
        for r in range(n_runs):
            res = per_run[r]
            cost = Decimal(sum(res['disconnected_costs']))
            paths = res['disconnected_paths'] or [()] * len(tn)
            full_path = tn_utils.merge_contraction_paths(len(tn), paths)
            results.append(
                ContractionResults(
                    cost=cost,
                    runtime_s=res['runtime_s'],
                    path=full_path,
                    disconnected_costs=res['disconnected_costs'],
                    disconnected_paths=paths))

        if self.verbose == 1:
            print(" Done!", file=stderr, flush=True)

        return self._dump_results(tn, sorted(results))

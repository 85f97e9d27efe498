"""The system under test: the port's replica runners, built, widened and
driven as a configuration file says.

This is the only module of the benchmark that imports the program
(``tnco_tpu_torch``).  A configuration names its runner under
``"runner"``: ``"ReplicaRunner"`` (infinite memory) or
``"ReplicaRunnerFW"`` (a width cap, ``"max_width"``), with ``"engine"``
(``"auto"`` picks as users get it) and ``"n_walks"``.  A traffic
mix's optional ``"run_options"`` are keywords of every ``run`` call (a
``"chunk_size"`` among them splits a chunk into that many iterations a
``run`` chunk, so that, say, ``"exchange_every"`` acts inside it).

Set-up builds the runner on the distinct starting trees, one replica
each, as users build it, and then repeats their states on the device to
the cell's replica count with the program's stacking helpers
(``replica_state``/``from_states`` and their finite-width forms).  Each
replica of the widened batch gets its own seed word and the batch's
generator is seeded from all of them, so every replica draws its own
stream.  The widening sets the runner's batch attributes (``states``,
``n_replicas``) and then calls the runner's own private initialisers,
``_set_block`` (the replica block) and ``_init_draws`` (the walk
positions and the generator), as its constructor does.
"""

import dataclasses

import numpy as np

__all__ = ['build', 'widen', 'run_chunk', 'proposals', 'sweep_steps',
           'fused_network', 'Answers', 'answers', 'count_applied',
           'count_walked']

# Engines whose iteration is ``n_walks`` walk steps a replica.
WALK_ENGINES = ('walker', 'walks', 'multiwalk')


def _fw(config) -> bool:
    return config['runner'] == 'ReplicaRunnerFW'


def build(config, ts_inds, output_inds, dims, order, paths, seeds, device):
    """The runner on one replica per path (``seeds`` one per path)."""
    from tnco_tpu_torch.ctree import ContractionTree
    from tnco_tpu_torch.parallel.replicas import (ReplicaRunner,
                                                  ReplicaRunnerFW)

    ctrees = [ContractionTree(p, ts_inds, dims, output_inds=output_inds,
                              check_shared_inds=True, inds_order=order)
              for p in paths]
    kw = dict(engine=config['engine'], n_walks=config['n_walks'],
              device=device)
    seeds = [int(s) for s in seeds]
    if _fw(config):
        from tnco_tpu_torch.optimize.finite_width.cost_model import \
            SimpleCostModel
        return ReplicaRunnerFW(ctrees, seeds, cmodel=SimpleCostModel(
            max_width=config['max_width']), **kw)
    if config['runner'] != 'ReplicaRunner':
        raise ValueError(f"Unknown runner {config['runner']!r}.")
    return ReplicaRunner(ctrees, seeds, **kw)


def widen(runner, seeds) -> None:
    """Repeats the runner's replicas to ``len(seeds)`` lanes in place:
    lane ``r`` starts from replica ``r % n`` and carries ``seeds[r]``."""
    import torch
    from tnco_tpu_torch.kernels import sa_batched as sb
    from tnco_tpu_torch.kernels import sa_finite_batched as sfb
    from tnco_tpu_torch.parallel import replicas

    b = len(seeds)
    fw = isinstance(runner.states, sfb.SABatchFW)
    one = sfb.replica_state_fw if fw else sb.replica_state
    stack = sfb.from_states_fw if fw else sb.from_states
    # Each replica's state as its own tensors (a state the helper returns
    # views one copy of the whole batch).
    base = []
    for i in range(runner.n_replicas):
        s = one(runner.states, i)
        base.append(type(s)(**{f.name: getattr(s, f.name).clone()
                               for f in dataclasses.fields(s)}))
    runner.states = None
    states = stack([base[r % len(base)] for r in range(b)])
    del base
    words = np.asarray([int(s) & 0xFFFFFFFF for s in seeds],
                       dtype=np.uint32).view(np.int32)
    states.keys[:, 1] = torch.from_numpy(words).to(states.keys.device)
    runner.states = states
    runner.n_replicas = b
    replicas._set_block(runner, b)
    replicas._init_draws(runner, [int(s) for s in seeds])


def run_chunk(runner, config, traffic, betas) -> None:
    """One ``run`` call over ``betas`` (one chunk)."""
    kw = {'chunk_size': len(betas), **traffic.get('run_options', {})}
    if len(betas) % kw['chunk_size']:
        raise ValueError(f"run_options' chunk_size {kw['chunk_size']} does "
                         f'not divide a chunk of {len(betas)} iterations.')
    if _fw(config):
        kw['update_slices'] = traffic['update_slices']
    runner.run(betas, **kw)


def sweep_steps(n_leaves: int) -> int:
    """Internal nodes of a tree of ``n_leaves`` leaves, ``n_leaves - 1``:
    the proposals of a 'sweep' round a replica, and the most steps a
    'batched' walk can take (the program's bound,
    ``kernels/sa_batched.max_walk_steps``, copied so that no change to the
    program moves it)."""
    return max(int(n_leaves) - 1, 0)


def proposals(runner, chunks: int, k: int, n_leaves: int,
              walked: int) -> int:
    """The proposals of ``chunks`` chunks of ``k`` iterations on
    ``runner``'s ``n_replicas`` replicas (B), by the engine it runs
    (``runner.engine``, what 'auto' picked):

    - 'walker', 'walks', 'multiwalk': an iteration is one step of each of
      the replica's ``n_walks`` (P) walks, one proposal each:
      ``chunks * k * P * B``;
    - 'sweep': an iteration is a round that proposes at every internal
      node of each replica: ``chunks * k * (L - 1) * B``;
    - 'batched': an iteration is a sweep, one walk a replica from a
      drawn leaf up through its ancestors, one proposal at each node
      that has a parent; the walk stops below the root, so a leaf at
      depth ``d`` takes ``d - 1`` steps, which change as the trees do.
      The count is ``walked``, the steps that the runner walked in these
      chunks (:func:`count_walked`), held to the bound
      ``chunks * k * (L - 1) * B``.

    Raises ``ValueError`` for any other engine ('vmapped', 'native'),
    whose count no cell has defined, and for a 'batched' count outside
    ``(0, bound]``."""
    b = runner.n_replicas
    if runner.engine in WALK_ENGINES:
        return chunks * k * runner.n_walks * b
    bound = chunks * k * sweep_steps(n_leaves) * b
    if runner.engine == 'sweep':
        return bound
    if runner.engine == 'batched':
        if not 0 < walked <= bound:
            raise ValueError(f'{walked} walk steps in {chunks} chunks of '
                             f'{k} sweeps: outside (0, {bound}].')
        return walked
    raise ValueError(f'No proposal count for engine {runner.engine!r}.')


def fused_network(network: dict, max_width: float, seed: int):
    """``(ts_inds, output_inds, dims)`` of ``network`` (a configuration's
    entry) after the program's fusion (``utils.tn.fuse`` at ``max_width``,
    then ``utils.tn.contract`` along its path), as ``load_tn`` fuses a
    network at its default ``fuse=4``, with the fusion's draws from
    ``seed``.  Freeze the result with ``python3 -m portbench.networks
    write``: the benchmark never fuses at run time."""
    from portbench import networks
    from tnco_tpu_torch.utils import tn

    ts_inds, output_inds, dims = networks.build(network)
    path = tn.fuse(ts_inds, dims, max_width=max_width,
                   output_inds=output_inds, seed=int(seed))
    ts_inds, output_inds = tn.contract(path, ts_inds, output_inds, dims=dims)
    return ts_inds, output_inds, {x: dims[x] for x in
                                  networks.index_order(ts_inds)}


@dataclasses.dataclass
class Answers:
    """What the program reports for the judged replicas: each replica's
    best tree (``c0, c1, par``), its slice words (finite width), its
    reported best log2 cost, and its current tree and slice words."""
    replicas: list
    best: list
    slices: list
    reported: list
    current: list
    current_slices: list


def answers(runner, replicas, fw: bool) -> Answers:
    """The program's answers for ``replicas``, through the runner's
    public accessors."""
    totals = runner.log2_min_totals()
    best, slices, current, current_slices = [], [], [], []
    for r in replicas:
        t = runner.min_ctree(r).nodes_array
        best.append((t[:, 0].copy(), t[:, 1].copy(), t[:, 2].copy()))
        slices.append(runner.min_slices_lanes(r) if fw else None)
        t = runner.ctree(r).nodes_array
        current.append((t[:, 0].copy(), t[:, 1].copy(), t[:, 2].copy()))
        current_slices.append(runner.slices_lanes(r) if fw else None)
    return Answers(list(replicas), best, slices,
                   [float(totals[r]) for r in replicas], current,
                   current_slices)


def count_applied(runner) -> int:
    """The moves the runner has applied so far (its own counter)."""
    return int(runner.applied_done or 0)


def count_walked(runner) -> int:
    """The walk steps the runner has taken so far (its own counter, a
    proposal each)."""
    return int(runner.moves_done)

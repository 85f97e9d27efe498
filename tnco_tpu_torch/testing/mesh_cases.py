"""Rank bodies of the mesh checks: each runs on every rank of a process
group started by :func:`tnco_tpu_torch.mesh.spawn` (gloo ranks on the CPU
in the tests; ranks on the card in ``chip_smoke.py``) and returns what the
caller compares with a one-device run or with the JAX package.

Networks travel as ``{'ts', 'out', 'dims', 'order', 'paths'}`` (plain
lists, built once by the caller), so that every rank builds the same
trees whatever its hash seed.
"""

import numpy as np
import torch

from tnco_tpu_torch import mesh as tmesh
from tnco_tpu_torch.convert import batch_from_numpy, batch_fw_from_numpy
from tnco_tpu_torch.ctree import ContractionTree
from tnco_tpu_torch.optimize.finite_width import SimpleCostModel
from tnco_tpu_torch.parallel import replicas as trep

__all__ = ['network', 'trees', 'build_runner', 'run_case', 'exchange_blocks',
           'runner_views', 'local_fields', 'join_blocks', 'sharded_runs',
           'exchange_cases', 'mesh_rules']


def network(ts, out, dims, paths) -> dict:
    """A network and its replicas' paths as plain lists."""
    return {'ts': [list(x) for x in ts], 'out': list(out),
            'dims': dict(dims), 'paths': [list(map(tuple, p)) for p in paths],
            'order': list(dict.fromkeys(x for xs in ts for x in xs))}


def trees(net: dict) -> list:
    return [ContractionTree(p, net['ts'], net['dims'], output_inds=net['out'],
                            inds_order=tuple(net['order']))
            for p in net['paths']]


def build_runner(case: dict, ctrees, seeds, mesh=None, device='cpu'):
    """The runner of ``case`` (``{'fw', 'engine', 'kw', 'max_width'}``)."""
    kw = dict(case.get('kw', {}))
    if case['fw']:
        kw['cmodel'] = SimpleCostModel(max_width=case['max_width'])
        cls = trep.ReplicaRunnerFW
    else:
        cls = trep.ReplicaRunner
    return cls(ctrees, seeds, engine=case['engine'], mesh=mesh,
               device=device, **kw)


def run_case(runner, case: dict, blocks=None) -> dict:
    """Runs ``case['betas']`` with ``case['run']``.  A one-device runner
    given ``blocks=(shape, axis_names)`` runs an exchange the way a mesh
    of that shape runs it (:func:`exchange_blocks` between chunks), so
    that it is the sharded run's one-device counterpart."""
    betas = np.asarray(case['betas'], dtype=np.float32)
    run = dict(case.get('run', {}))
    if runner.mesh is None and blocks and run.get('exchange_every'):
        _run_exchanged(runner, betas, run, blocks)
        info = {'log2_min_total': runner.log2_min_totals(),
                'sweeps': runner.sweeps_done, 'moves': runner.moves_done,
                'applied': runner.applied_done}
    else:
        info = runner.run(betas, **run)
    return {k: info[k] for k in ('log2_min_total', 'sweeps', 'moves',
                                 'applied')}


def _run_exchanged(runner, betas, run, blocks) -> None:
    chunk = run.pop('chunk_size')
    every = run.pop('exchange_every')
    axes = run.pop('exchange_axes', None)
    fraction = run.pop('exchange_fraction', 0.25)
    if len(betas) % chunk or chunk % run.get('update_slices', 1):
        raise ValueError("the chunks must split the betas and hold whole "
                         "reslice periods.")
    for i, pos in enumerate(range(0, len(betas), chunk)):
        runner.run(betas[pos:pos + chunk], chunk_size=chunk, **run)
        if pos + chunk < len(betas) and (i + 1) % every == 0:
            runner.states = exchange_blocks(runner.states, *blocks, axes,
                                            fraction)


def exchange_blocks(states, shape, axis_names, axes=None,
                    fraction: float = 0.25):
    """The sharded exchange (:func:`~tnco_tpu_torch.parallel.replicas.
    exchange_best_sharded`, or its FW form for an ``SABatchFW``) of a mesh
    of ``shape`` / ``axis_names`` over ``axes``, computed on the whole
    batch on one device: its plain counterpart.  Rank ``r`` holds the
    lanes ``[r * b, (r + 1) * b)``; each group takes its best current
    lane (the lowest row-major rank index over ``axes`` among ties) and
    each rank of it restarts its local worst lanes from that lane."""
    import dataclasses
    import math

    from tnco_tpu_torch.kernels.sa_finite_batched import SABatchFW

    names = tuple(axis_names)
    axes = names if axes is None else ((axes,) if isinstance(axes, str)
                                       else tuple(axes))
    n_ranks = math.prod(shape)
    lt = states.log2_total
    b = lt.shape[0] // n_ranks
    coords = np.stack(np.unravel_index(np.arange(n_ranks), shape), axis=1)
    other = [names.index(a) for a in names if a not in axes]
    lin = [int(np.ravel_multi_index(
        tuple(c[names.index(a)] for a in axes),
        tuple(shape[names.index(a)] for a in axes))) for c in coords]
    groups = {}
    for r in range(n_ranks):
        groups.setdefault(tuple(coords[r, other]), []).append(r)
    src = torch.arange(lt.shape[0], device=lt.device)
    worst = torch.zeros_like(lt, dtype=torch.bool)
    new_lt = lt.clone()
    k = max(1, int(b * fraction))
    for ranks in groups.values():
        best = {r: r * b + int(torch.argmin(lt[r * b:(r + 1) * b]))
                for r in ranks}
        gmin = torch.stack([lt[best[r]] for r in ranks]).min()
        owner = min((lin[r], r) for r in ranks if lt[best[r]] == gmin)[1]
        for r in ranks:
            block = lt[r * b:(r + 1) * b]
            thresh = torch.sort(block).values[b - k]
            w = (block >= thresh) & (block > gmin)
            worst[r * b:(r + 1) * b] = w
            src[r * b:(r + 1) * b] = torch.where(w, best[owner],
                                                 src[r * b:(r + 1) * b])
            new_lt[r * b:(r + 1) * b] = torch.where(w, gmin, block)
    fields = ('c0', 'c1', 'par', 'inds', 'hyper', 'lcc')
    if isinstance(states, SABatchFW):
        fields += ('width', 'slices')
    mixed = {f: getattr(states, f).index_select(-1, src) for f in fields}
    return dataclasses.replace(states, log2_total=new_lt, **mixed)


def runner_views(runner) -> dict:
    """What the runner's accessors return for every replica (collectives
    on a mesh: every rank calls them)."""
    b = runner.n_replicas
    out = {'log2_min_totals': runner.log2_min_totals()}
    if hasattr(runner, 'best'):                 # ReplicaRunner only
        out['best'] = runner.best()
    for name, fn in (('min_trees', runner.min_ctree), ('trees', runner.ctree)):
        out[name] = [(t.nodes_array, t.inds_array) for t in map(fn, range(b))]
    if hasattr(runner, 'slices_lanes'):
        out['slices'] = [runner.slices_lanes(i) for i in range(b)]
        out['min_slices'] = [runner.min_slices_lanes(i) for i in range(b)]
    return out


def local_fields(states) -> dict:
    """The state's fields as host arrays (this rank's block on a mesh)."""
    return {f: getattr(states, f).cpu().numpy()
            for f in type(states).field_names()}


def _replica_axis(name: str, replica_major: bool) -> int:
    return 0 if replica_major or name == 'keys' else -1


def join_blocks(blocks: list, replica_major: bool = False) -> dict:
    """The ranks' :func:`local_fields` joined along the replica axis."""
    return {f: np.concatenate([b[f] for b in blocks],
                              axis=_replica_axis(f, replica_major))
            for f in blocks[0]}


def sharded_runs(spec: dict) -> list:
    """Rank body: on a mesh of ``spec['shape']`` / ``spec['axis_names']``
    (1-D when absent) over every rank, builds each runner of
    ``spec['cases']`` on the network ``spec['net']`` with ``spec['seeds']``
    and runs it; returns, per case, the run's counts, the accessors'
    views and the rank's block of the state."""
    mesh = tmesh.make_mesh(shape=spec.get('shape'),
                           axis_names=spec.get('axis_names'))
    ctrees = trees(spec['net'])
    out = []
    for case in spec['cases']:
        runner = build_runner(case, ctrees, spec['seeds'], mesh,
                              spec.get('device', 'cpu'))
        info = run_case(runner, case)
        out.append({'info': info, 'views': runner_views(runner),
                    'local': local_fields(runner.states),
                    'pos': runner._mw_pos.cpu().numpy()})
    return out


def _block(fields: dict, lo: int, hi: int) -> dict:
    return {f: (x[lo:hi] if f == 'keys' else x[..., lo:hi])
            for f, x in fields.items()}


def exchange_cases(spec: dict) -> list:
    """Rank body: the sharded exchanges on the rank's block of whole
    batches given as JAX-layout numpy fields (``spec['batches']``, each
    ``(fw, fields)``), over each of ``spec['axes']``, with
    ``spec['fraction']``; returns the rank's blocks after each."""
    mesh = tmesh.make_mesh(shape=spec['shape'],
                           axis_names=spec['axis_names'])
    block = tmesh.replica_sharding(mesh)
    out = []
    for fw, fields in spec['batches']:
        lo, hi = block.bounds(fields['log2_total'].shape[0])
        make = batch_fw_from_numpy if fw else batch_from_numpy
        fn = trep.exchange_best_fw_sharded if fw else \
            trep.exchange_best_sharded
        for axes in spec['axes']:
            states = make(_block(fields, lo, hi), spec.get('device', 'cpu'))
            new = fn(states, mesh, axes, spec['fraction'])
            out.append(local_fields(new))
    return out


def mesh_rules(spec: dict) -> dict:
    """Rank body of the mesh's rules on a ``(2, 2)`` ('dcn', 'ici') mesh
    of four ranks: 'ici' exchange groups do not mix, a mesh-wide exchange
    crosses 'dcn', an exchange over two axes of a ``(1, 2, 2)`` mesh
    equals the one over both axes of the ``(2, 2)`` mesh, the rank's
    replica block split over every axis, over 'ici', 'dcn' and ('ici',
    'dcn') (``replica_sharding``'s ``axis_name``), and the runners refuse
    'sweep', a replica count that does not split, and what is not a
    mesh."""
    mesh = tmesh.make_mesh(shape=(2, 2), axis_names=('dcn', 'ici'))
    ctrees = trees(spec['net'])
    seeds = spec['seeds']
    runner = trep.ReplicaRunner(ctrees, seeds, engine='batched', mesh=mesh,
                                device='cpu')
    runner.run(np.linspace(0, 5, 8, dtype=np.float32), chunk_size=8)
    before = tmesh.gather_blocks(runner.states.log2_total,
                                 runner._block).numpy()
    start = runner.states
    runner.states = trep.exchange_best_sharded(start, mesh, ('ici',), 1.0)
    after_ici = tmesh.gather_blocks(runner.states.log2_total,
                                    runner._block).numpy()
    runner.states = trep.exchange_best_sharded(runner.states, mesh,
                                               fraction=1.0)
    after_all = tmesh.gather_blocks(runner.states.log2_total,
                                    runner._block).numpy()
    mesh3 = tmesh.make_mesh(shape=(1, 2, 2), axis_names=('a', 'b', 'c'))
    two = trep.exchange_best_sharded(start, mesh3, ('b', 'c'), 0.5)
    both = trep.exchange_best_sharded(start, mesh, ('dcn', 'ici'), 0.5)
    same = all(torch.equal(getattr(two, f), getattr(both, f))
               for f in type(two).field_names())
    blocks = {}
    for axes in (None, 'ici', 'dcn', ('ici', 'dcn')):
        block = tmesh.replica_sharding(mesh, axes)
        blocks[str(axes)] = (block.index, block.count)
    runner.run(np.linspace(5, 10, 8, dtype=np.float32), chunk_size=2,
               exchange_every=1, exchange_axes=('ici',))
    valid = all(runner.ctree(i).is_valid(check_shared_inds=True)
                for i in range(runner.n_replicas))
    errors = {}
    for name, make in (
            ('sweep', lambda: trep.ReplicaRunner(
                ctrees, seeds, engine='sweep', mesh=mesh, device='cpu')),
            ('sweep fw', lambda: trep.ReplicaRunnerFW(
                ctrees, seeds, engine='sweep', mesh=mesh, device='cpu',
                cmodel=SimpleCostModel(max_width=30))),
            ('split', lambda: trep.ReplicaRunner(
                ctrees[:6], seeds[:6], engine='batched', mesh=mesh,
                device='cpu')),
            ('not a mesh', lambda: trep.ReplicaRunner(
                ctrees, seeds, engine='walks', mesh=object(),
                device='cpu'))):
        try:
            make()
            errors[name] = None
        except (TypeError, ValueError) as e:
            errors[name] = f'{type(e).__name__}: {e}'
    return {'before': before, 'after_ici': after_ici,
            'after_all': after_all, 'two_of_three': same, 'valid': valid,
            'errors': errors, 'blocks': blocks}


def probe_collectives(device) -> dict:
    """``{'<op> <dtype>': 'ok' or the error}``: which all-reduces the
    default process group takes on tensors of ``device``."""
    out = {}
    for dtype in (torch.int32, torch.int64, torch.float32):
        for op in ('sum', 'min', 'max'):
            key = f"{op} {str(dtype).split('.')[-1]}"
            try:
                tmesh.all_reduce(torch.ones(2, dtype=dtype, device=device),
                                 op)
                out[key] = 'ok'
            except RuntimeError as e:
                out[key] = str(e).splitlines()[0]
    return out


def _k5_check(runner, k: int = 4) -> dict:
    """K5 (IM, or FW with reslices after steps 2 and 4) against its plain
    version on this rank's block of ``runner``, from its current state on
    the same pre-drawn streams: ``{'equal', 'applied'}``."""
    from tnco_tpu_torch.kernels import sa_multiwalk as smw
    from tnco_tpu_torch.kernels import walker as kw

    s, pos, p = runner.states, runner._mw_pos, runner.n_walks
    dev, b = pos.device, pos.shape[1]
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    betas = torch.linspace(1.0, 2.0, k, device=dev)
    if hasattr(s, 'slices'):
        mask = np.arange(1, k + 1) % 2 == 0
        draws = smw.fw_draws(None, gen, mask, runner.cfg, p, b,
                             torch.float32, dev)
        args = (s, betas, mask, runner.max_width, runner.log2d_w32,
                runner.skip_lanes, runner.cfg, p, pos)
        kw_ = dict(uniform_log2=runner.uniform_log2, draws=draws)
        got, mg = kw.run_walker_fw(*args, **kw_)
        want, mw = kw.run_walker_fw_plain(*args, **kw_)
    else:
        draws = smw.draw_chunk(gen, runner.cfg.n_leaves, k, p, b)
        args = (s, betas, runner.log2d_w32, runner.cfg, p, pos)
        got, mg = kw.run_walker(*args, draws=draws)
        want, mw = kw.run_walker_plain(*args, draws=draws)
    equal = (all(torch.equal(getattr(got, f), getattr(want, f))
                 for f in type(got).field_names()) and
             torch.equal(mg['pos'], mw['pos']) and
             int(mg['applied']) == int(mw['applied']))
    return {'equal': equal, 'applied': int(mg['applied'])}


def _sync(dev) -> None:
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def card_runs(spec: dict) -> dict:
    """Rank body of the card's mesh checks (``chip_smoke.py`` phase 25),
    on ``spec['device']`` (the rank's card): builds the runners of
    ``spec['cases']`` on a mesh of ``spec['shape']`` and runs them with
    the launch counts set to 0 just before and read just after; then
    holds K1 and K3 against their plain versions at every shape launched,
    and K5 (each 'walker' case) against its plain version on the rank's
    block.  With ``spec['one_device']`` it also runs every case without
    a mesh in this rank and reports whether the states are bitwise
    equal, and whether the sharded exchanges equal the one-device ones
    (one rank).  Returns the counts, times, checks and the rank's state
    blocks."""
    import time

    from tnco_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tnco_tpu_torch.testing import kernel_cases as kc

    dev = tmesh.rank_device(spec.get('device'))
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    probe = probe_collectives(dev)
    mesh = tmesh.make_mesh(shape=spec.get('shape'),
                           axis_names=spec.get('axis_names'))
    ctrees = trees(spec['net'])
    t0 = time.perf_counter()
    runners = [build_runner(c, ctrees, spec['seeds'], mesh, dev)
               for c in spec['cases']]
    _sync(dev)
    t1 = time.perf_counter()
    reset_launch_counts()
    with kc.recorded_cases() as seen:
        infos = [run_case(r, c) for r, c in zip(runners, spec['cases'])]
        _sync(dev)
    counts = launch_counts()
    t2 = time.perf_counter()
    out = {'probe': probe, 'counts': counts, 'setup_s': t1 - t0,
           'run_s': t2 - t1, 'infos': infos, 'device': str(dev),
           'local': [local_fields(r.states) for r in runners],
           'pos': [r._mw_pos.cpu().numpy() for r in runners],
           'n_shapes': len(seen)}
    out['bad'] = []
    for case, dtype in sorted(seen, key=repr):
        check = kc.check_gather if isinstance(case, kc.GatherCase) else \
            kc.check_scatter
        err = check(case, dtype, dev)
        if err:
            out['bad'].append(f'{case.name} {dtype}: {err}')
    out['k5'] = [_k5_check(r) for r in runners if r.engine == 'walker']
    if spec.get('one_device'):
        out['one_device_equal'] = []
        for runner, case in zip(runners, spec['cases']):
            one = build_runner(case, ctrees, spec['seeds'], None, dev)
            run_case(one, case)
            out['one_device_equal'].append(all(
                torch.equal(getattr(one.states, f), getattr(runner.states, f))
                for f in type(one.states).field_names()))
            if case['engine'] in ('batched', 'walks'):
                fw = case['fw']
                sharded = (trep.exchange_best_fw_sharded if fw else
                           trep.exchange_best_sharded)(runner.states, mesh)
                plain = (trep.exchange_best_fw if fw else
                         trep.exchange_best)(runner.states)
                out.setdefault('exchange_equal', []).append(all(
                    torch.equal(getattr(sharded, f), getattr(plain, f))
                    for f in type(plain).field_names()))
    return out

"""Infinite-memory replica-major state and the 'vmapped' engine (the port
of ``tnco_tpu/kernels/sa_infinite.py``: ``SweepConfig`` :41,
``SAStateIM`` :52-86, ``compute_hyper`` :88, ``compute_lcc`` :100,
``init_state`` :114, ``sweep`` :141, ``run_sweeps`` :236-251,
``run_sweeps_batch`` :254-263, ``state_to_ctree`` :266).

One ``sweep`` is the reference SA update (include/tnco/optimize/
infinite_memory/optimizer.hpp:90-221): a random leaf, a walk to the
root, at every internal node ``B`` the swap of ``B``'s uncle with one of
its children, Metropolis-accepted on the log2 total.

The JAX package runs this sweep per replica under ``vmap`` and holds it
to the same trajectory as its lockstep 'batched' engine
(``tnco_tpu/parallel/replicas.py:231``); the two differ only in layout.
So here the sweep is not written a second time: :func:`run_sweeps_batch`
maps the replica-major :class:`SAStateIM` (replica axis FIRST) onto the
lockstep batch, runs :func:`~tnco_tpu_torch.kernels.sa_batched.
run_sweeps_per_replica` on it (rows read by K1 and written by K3 on the
card) and maps the result back; :func:`run_sweeps` and :func:`sweep`
are the same call at one replica.  The draws are the lockstep engine's:
``draws=`` (tests inject the JAX threefry draws) or a
``torch.Generator``.  ``key`` holds the replica's seed words ``[0,
seed]``, carried as the lockstep batch carries them.
"""

from dataclasses import dataclass, fields

import numpy as np
import torch

from tnco_tpu_torch.device import resolve_device
from tnco_tpu_torch.kernels import sa_batched as sb
from tnco_tpu_torch.ops import bitops
from tnco_tpu_torch.ops import costs as costs_ops

__all__ = ['SweepConfig', 'SAStateIM', 'compute_hyper', 'compute_lcc',
           'init_state', 'sweep', 'run_sweeps', 'run_sweeps_batch',
           'state_to_ctree', 'from_batch', 'to_batch', 'NULL']

NULL = -1


@dataclass(frozen=True)
class SweepConfig:
    """Static kernel configuration."""
    n_leaves: int
    n_lanes: int
    disable_shared_inds: bool = False
    prob_kind: str = 'mh'  # 'mh' | 'greedy' | 'base'
    use_sparse: bool = False


@dataclass
class SAStateIM:
    """Replica-major infinite-memory state (torch tensors on one device).

    For one replica: ``nodes/min_nodes: int32 [N, 3]`` (c0, c1, par);
    ``inds/hyper/min_inds: int32 [N, W]`` bit patterns (``hyper = inds &
    inds[c0] & inds[c1]``, infinite_memory/utils.hpp:68-100); ``lcc:
    float [N]`` log2 contraction costs (-inf at leaves);
    ``log2_total/min_log2_total: float []``; ``key: int32 [2]``.  A
    stack of replicas has a leading replica axis on every field.
    """
    nodes: torch.Tensor
    inds: torch.Tensor
    hyper: torch.Tensor
    lcc: torch.Tensor
    log2_total: torch.Tensor
    min_log2_total: torch.Tensor
    min_nodes: torch.Tensor
    min_inds: torch.Tensor
    key: torch.Tensor

    @classmethod
    def field_names(cls):
        return tuple(f.name for f in fields(cls))


def _children(nodes):
    internal = nodes[:, 0] != NULL
    c0 = torch.where(internal, nodes[:, 0], 0).long()
    c1 = torch.where(internal, nodes[:, 1], 0).long()
    return internal, c0, c1


def compute_hyper(nodes, inds):
    """The hyper cache ``inds & inds[c0] & inds[c1]`` of one replica
    (leaves get empty sets)."""
    internal, c0, c1 = _children(nodes)
    hyper = inds & inds[c0] & inds[c1]
    return torch.where(internal[:, None], hyper, torch.zeros_like(hyper))


def compute_lcc(nodes, inds, log2_dims_padded, *, sparse_lanes=None,
                log2_n_projs=None):
    """Per-node log2 contraction costs of one replica (leaves -> -inf),
    the sparse part capped at ``log2_n_projs`` if ``sparse_lanes``."""
    internal, c0, c1 = _children(nodes)
    lcc = costs_ops.ccost_log2(inds[c0] | inds[c1], log2_dims_padded,
                               sparse_lanes=sparse_lanes,
                               log2_n_projs=log2_n_projs)
    return torch.where(internal, lcc, -torch.inf).to(log2_dims_padded.dtype)


def seed_key(seed) -> torch.Tensor:
    """A replica's seed words ``[0, seed mod 2**32]`` as int32 (the
    layout of a threefry ``PRNGKey(seed)``, as ``init_batch`` keeps it)."""
    words = np.asarray([0, int(seed) & 0xFFFFFFFF], dtype=np.uint32)
    return torch.from_numpy(words.view(np.int32).copy())


def init_state(ctree, seed, log2_dims_padded=None, dtype=torch.float32, *,
               sparse_lanes=None, log2_n_projs=None,
               device=None) -> SAStateIM:
    """The state of one replica from a host tree, on ``device`` (None
    means the card).  ``sparse_lanes``: ``uint32 [W]`` (numpy) or int32
    tensor."""
    dev = resolve_device(device)
    nodes = torch.from_numpy(np.ascontiguousarray(
        ctree.nodes_array, dtype=np.int32)).to(dev)
    inds = bitops.as_lanes(ctree.inds_array, dev)
    if log2_dims_padded is None:
        log2_dims_padded = bitops.pad_log2_dims(
            ctree.log2_dims_array, inds.shape[1], dtype, dev)
    log2d = torch.as_tensor(log2_dims_padded, dtype=dtype, device=dev)
    hyper = compute_hyper(nodes, inds)
    lcc = compute_lcc(nodes, inds, log2d,
                      sparse_lanes=bitops.as_lanes(sparse_lanes, dev),
                      log2_n_projs=log2_n_projs)
    lt = costs_ops.log2_total_from_lcc(lcc, ctree.n_leaves)
    return SAStateIM(nodes, inds, hyper, lcc, lt, lt.clone(), nodes.clone(),
                     inds.clone(), seed_key(seed).to(dev))


def from_batch(batch: sb.SABatch) -> SAStateIM:
    """Lane-major :class:`~tnco_tpu_torch.kernels.sa_batched.SABatch` ->
    stacked replica-major state (``replicas.py:85-94``)."""
    def nodes(c0, c1, par):
        return torch.stack([c0.T, c1.T, par.T], dim=2).contiguous()

    def rows(x):
        return x.permute(2, 0, 1).contiguous()

    return SAStateIM(nodes(batch.c0, batch.c1, batch.par), rows(batch.inds),
                     rows(batch.hyper), batch.lcc.T.contiguous(),
                     batch.log2_total, batch.min_log2_total,
                     nodes(batch.min_c0, batch.min_c1, batch.min_par),
                     rows(batch.min_inds), batch.keys)


def to_batch(states: SAStateIM) -> sb.SABatch:
    """Inverse of :func:`from_batch`."""
    def cols(nodes, k):
        return nodes[..., k].T.contiguous()

    def lanes(x):
        return x.permute(1, 2, 0).contiguous()

    s = states
    return sb.SABatch(cols(s.nodes, 0), cols(s.nodes, 1), cols(s.nodes, 2),
                      lanes(s.inds), lanes(s.hyper), s.lcc.T.contiguous(),
                      s.log2_total, s.min_log2_total, cols(s.min_nodes, 0),
                      cols(s.min_nodes, 1), cols(s.min_nodes, 2),
                      lanes(s.min_inds), s.key)


def stack(states) -> SAStateIM:
    """Stacks single-replica states (of one class) along a new leading
    replica axis."""
    cls = type(states[0])
    return cls(**{k: torch.stack([getattr(s, k) for s in states])
                  for k in cls.field_names()})


def unstack(states, i: int):
    """Replica ``i`` of a stacked state."""
    cls = type(states)
    return cls(**{k: getattr(states, k)[i] for k in cls.field_names()})


def run_sweeps_batch(states: SAStateIM, betas, log2_dims_padded,
                     cfg: SweepConfig, sparse_lanes=None, log2_n_projs=None,
                     *, uniform_log2=None, draws=None, generator=None):
    """One sweep per beta for every replica of a stacked state (the JAX
    package's ``vmap`` of ``run_sweeps``), on the state's device.

    ``log2_dims_padded: [W * 32]``; ``sparse_lanes`` and
    ``log2_n_projs``: the sparse cost model's cap, or None.
    ``uniform_log2``: the common log2 dim where every dim is equal (the
    popcount widths, bitwise equal to the pinned tree on integer log2
    dims), or None.  ``draws``/``generator``: as for
    :func:`~tnco_tpu_torch.kernels.sa_batched.run_sweeps_batched`
    (``leaf [K, B]``, ``rand_bit``, ``u [K, T, B]``).  Returns the new
    state and ``{'log2_total', 'log2_min_total', 'moves'}``, each ``[B,
    K]``; the input is not modified.
    """
    batch = to_batch(states)
    dev = batch.c0.device
    w = batch.inds.shape[1]
    log2d_w32 = torch.as_tensor(log2_dims_padded, device=dev).reshape(w, 32)
    out, hist = sb.run_sweeps_per_replica(
        batch, betas, log2d_w32, cfg, bitops.as_lanes(sparse_lanes, dev),
        log2_n_projs, uniform_log2=uniform_log2, draws=draws,
        generator=generator)
    return from_batch(out), {k: v.T.contiguous() for k, v in hist.items()}


def run_sweeps(state: SAStateIM, betas, log2_dims_padded, cfg: SweepConfig,
               sparse_lanes=None, log2_n_projs=None, *, uniform_log2=None,
               draws=None, generator=None):
    """:func:`run_sweeps_batch` of one replica (``draws`` with ``B = 1``);
    metrics ``[K]``."""
    out, hist = run_sweeps_batch(stack([state]), betas, log2_dims_padded,
                                 cfg, sparse_lanes, log2_n_projs,
                                 uniform_log2=uniform_log2, draws=draws,
                                 generator=generator)
    return unstack(out, 0), {k: v[0] for k, v in hist.items()}


def sweep(state: SAStateIM, beta, log2_dims_padded, cfg: SweepConfig,
          sparse_lanes=None, log2_n_projs=None, *, uniform_log2=None,
          draws=None, generator=None):
    """One leaf-to-root sweep of one replica (the reference ``update``):
    :func:`run_sweeps` at one beta.  ``draws``: ``leaf [1, 1]``,
    ``rand_bit``, ``u [1, T, 1]``.  Returns ``(state, moves)``."""
    out, hist = run_sweeps(state, [float(beta)], log2_dims_padded, cfg,
                           sparse_lanes, log2_n_projs,
                           uniform_log2=uniform_log2, draws=draws,
                           generator=generator)
    return out, hist['moves'][0]


def state_to_ctree(template, nodes, inds):
    """A host ``ContractionTree`` from one replica's device arrays
    (``uint32`` words back from their int32 bit patterns)."""
    nodes = np.ascontiguousarray(torch.as_tensor(nodes).cpu().numpy())
    inds = np.ascontiguousarray(torch.as_tensor(inds).cpu().numpy())
    return template.replace_arrays(nodes, inds.view(np.uint32))

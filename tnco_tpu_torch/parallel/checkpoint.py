"""Checkpoint and resume of replica batches (the port of
``tnco_tpu/parallel/checkpoint.py``).

A checkpoint is a plain ``.npz`` (no pickle, safe to load) with the JAX
package's field names and word layout: ``uint32`` words on disk, the
port's int32 bit patterns in memory, so a JAX checkpoint of a 'batched'
runner loads here field for field.  The port draws from the runner's
``torch.Generator``, not from keys in the batch, so :func:`save_runner`
also stores the generator's state (``extra_generator``) and the device
type it runs on: a resumed runner continues bitwise.

Only the infinite-memory ``SABatch`` layout is checkpointed, as in the
JAX package: runners whose state is not an ``SABatch`` (the finite-width
runners, and the 'vmapped' engine's replica-major states) raise
``ValueError``.  The JAX ``save_runner`` writes only the IM fields of
such runners, and its ``load_runner`` then installs an ``SABatch`` that
the next ``run`` cannot use.
"""

from pathlib import Path

import numpy as np
import torch

from tnco_tpu_torch.device import resolve_device
from tnco_tpu_torch.kernels.sa_batched import SABatch

__all__ = ['save_batch', 'load_batch', 'save_runner', 'load_runner']

_FIELDS = ('c0', 'c1', 'par', 'inds', 'hyper', 'lcc', 'log2_total',
           'min_log2_total', 'min_c0', 'min_c1', 'min_par', 'min_inds',
           'keys')
# Fields of uint32 words (int32 bit patterns in memory).
_WORDS = ('inds', 'hyper', 'min_inds', 'keys')


def save_batch(path, batch: SABatch, **extra) -> None:
    """Saves an ``SABatch`` (plus metadata arrays) to ``path`` (.npz)."""
    arrays = {}
    for f in _FIELDS:
        x = getattr(batch, f).detach().cpu().numpy()
        arrays[f] = x.view(np.uint32) if f in _WORDS else x
    arrays.update({f'extra_{k}': np.asarray(v) for k, v in extra.items()})
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **arrays)


def load_batch(path, device=None):
    """Loads ``(SABatch on device, extra dict)`` saved by
    :func:`save_batch` (or by the JAX package's); ``device`` None means
    the card."""
    dev = resolve_device(device)
    data = np.load(Path(path))

    def up(x):
        x = np.ascontiguousarray(x)
        if x.dtype == np.uint32:
            x = x.view(np.int32)
        return torch.from_numpy(x.copy()).to(dev)

    batch = SABatch(*(up(data[f]) for f in _FIELDS))
    extra = {k[len('extra_'):]: data[k] for k in data.files
             if k.startswith('extra_')}
    return batch, extra


def _check_layout(runner) -> None:
    if getattr(runner, 'mesh', None) is not None:
        raise ValueError("A runner on a mesh holds one rank's block of the "
                         "replicas; checkpoints hold one-device runners.")
    if not isinstance(runner.states, SABatch):
        raise ValueError(
            f"engine={runner.engine!r} keeps a "
            f"{type(runner.states).__name__} state; checkpoints hold the "
            "infinite-memory SABatch layout only (the 'batched', 'walks', "
            "'walker', 'multiwalk' and 'sweep' engines of ReplicaRunner).")


def save_runner(path, runner) -> None:
    """Checkpoints a :class:`~tnco_tpu_torch.parallel.ReplicaRunner`: its
    batch, counters, walk positions and generator state."""
    _check_layout(runner)
    extra = dict(sweeps_done=runner.sweeps_done,
                 moves_done=runner.moves_done,
                 mw_pos=runner._mw_pos.cpu().numpy(),
                 generator=runner.generator.get_state().numpy(),
                 generator_device=runner.generator.device.type)
    if runner.applied_done is not None:
        extra['applied_done'] = runner.applied_done
    save_batch(path, runner.states, **extra)


def load_runner(path, runner) -> None:
    """Restores a checkpoint into an already-constructed runner.

    The runner must have been built from the same trees (shapes must
    match); the saved arrays replace its state, and a saved generator
    state its generator's (one of the same device type).
    """
    _check_layout(runner)
    batch, extra = load_batch(path, runner.device)
    if batch.c0.shape != runner.states.c0.shape:
        raise ValueError("Checkpoint shape does not match the runner.")
    if 'generator' in extra:
        saved = str(extra['generator_device'])
        if saved != runner.generator.device.type:
            raise ValueError(f"The checkpoint's generator ran on '{saved}'; "
                             "this runner's runs on "
                             f"'{runner.generator.device.type}'.")
    if 'mw_pos' in extra:
        pos = np.asarray(extra['mw_pos'])
        if pos.shape[0] != runner.n_walks:
            raise ValueError(
                f"Checkpoint has {pos.shape[0]} walks but the runner was "
                f"built with n_walks={runner.n_walks}.")
        runner._mw_pos = torch.from_numpy(pos.astype(np.int32)).to(
            runner.device)
    runner.states = batch
    if 'generator' in extra:
        runner.generator.set_state(torch.from_numpy(
            np.asarray(extra['generator'], dtype=np.uint8).copy()))
    runner.sweeps_done = int(extra.get('sweeps_done', 0))
    runner.moves_done = int(extra.get('moves_done', 0))
    runner.applied_done = (int(extra['applied_done'])
                           if 'applied_done' in extra else None)

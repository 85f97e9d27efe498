"""Application logic: ingestion, results, optimizer factory (the port's
copy of ``tnco_tpu/app/app.py``).

Reference surface: tnco/app/app.py — ``load_file`` (compressed/json/text
autodetect, :97-151), ``load_tn`` universal ingester (:154-570),
``dump_results`` (:573-712), ``BaseContractionResults`` (:48-94),
``BaseOptimizer`` knob dataclass (:715-795) and the ``Optimizer`` factory
dispatching on ``max_width`` (:798-878).
"""

import bz2
from collections.abc import Iterator
from dataclasses import dataclass
from decimal import Decimal
import gzip
from importlib import import_module
import io
import json
from pathlib import Path
import pickle
from random import Random
import re
import sys
from typing import Any
from warnings import warn

from tnco_tpu_torch.app.tn import Tensor, TensorNetwork
from tnco_tpu_torch.device import resolve_device
from tnco_tpu_torch.utils.tensor import asarray
import tnco_tpu_torch.utils.tn as tn_utils

__all__ = ['Optimizer', 'load_tn', 'dump_results']


def _validate_filepath(filename: str) -> None:
    if not isinstance(filename, (str, Path)) or not str(filename).strip():
        raise ValueError("'filename' is not valid (empty).")
    if '\x00' in str(filename) or '\n' in str(filename):
        raise ValueError("'filename' is not valid (control characters).")


class JSONEncoder(json.JSONEncoder):

    def default(self, obj) -> Any:
        match obj:
            case Decimal():
                return str(obj)
            case BaseContractionResults():
                return dict(cost=obj.cost,
                            runtime_s=obj.runtime_s,
                            path=obj.path)
            case _ if hasattr(obj, 'to_json'):
                return obj.to_json()
            case _:
                return super().default(obj)


@dataclass(repr=False, frozen=True, eq=False)
class BaseContractionResults:
    """Optimization result: exact cost, wall-clock, and the path.

    Sortable by cost (reference tnco/app/app.py:64-94).  ``cost`` is an
    exact ``Decimal`` computed with bigint arithmetic.
    """

    cost: Any
    runtime_s: float
    path: list

    def __lt__(self, other):
        if not isinstance(other, BaseContractionResults):
            raise ValueError("Cannot compare against '{}'.".format(
                type(other).__name__))
        return self.cost < other.cost

    def __repr__(self):
        return 'ContractionResults(cost={:1.3g}, runtime={:1.3g}s)'.format(
            float(self.cost), self.runtime_s)

    def to_json(self):
        return json.dumps(self, cls=JSONEncoder)


def load_file(filename: str) -> Any:
    """Loads an object from a (possibly gzip/bz2-compressed) file.

    Autodetects gzip, bz2, json, utf-8 text, else raw bytes
    (reference tnco/app/app.py:97-151).
    """
    _validate_filepath(filename)
    filename = Path(filename).expanduser()
    if not filename.is_file():
        raise FileNotFoundError(
            "'{}' does not exist or is not a file.".format(filename))

    def load(binary: bytes):
        if binary[:2] == b'\x1f\x8b':
            return load(gzip.decompress(binary))
        if binary[:2] == b'BZ':
            return load(bz2.decompress(binary))
        try:
            return json.loads(binary.decode())
        except (json.JSONDecodeError, UnicodeDecodeError):
            pass
        try:
            return binary.decode('utf-8')
        except UnicodeDecodeError:
            pass
        return binary

    with filename.open('rb') as file:
        return load(file.read())


def load_tn(obj: Any,
            *,
            fuse: float = 4,
            decompose_hyper_inds: bool = True,
            simplify_circuit: bool = True,
            initial_state: Any = '0',
            final_state: Any = '0',
            output_index_token: str = '*',
            sparse_index_token: str = '/',
            atol: float = 1e-5,
            dtype: Any | None = None,
            backend: str | None = None,
            seed: int | None = None,
            verbose: int = 0) -> TensorNetwork:
    """Loads a tensor network from any supported object type.

    Accepts (reference tnco/app/app.py:154-570): ``TensorNetwork``, a list
    of gates ``(matrix, qubits)``, a list of index rows
    ``(dim, name, name, ...)``, the same as a text block, QASM strings,
    cirq/qiskit circuits (and cirq JSON), filenames of any of the above
    (optionally compressed), or ``'stdin'``.

    Examples:
        >>> from tnco_tpu_torch.app import load_tn
        >>> # Index rows: 'i' (dim 2) connects tensors 2 and 'j', etc.
        >>> tn = load_tn([[2, 'i', 'j'], [2, 'j', 'k']],
        ...              fuse=0, decompose_hyper_inds=False)
        >>> tn.n_tensors
        3
        >>> sorted(len(t.inds) for t in tn.tensors)
        [1, 1, 2]
    """
    options = dict(fuse=fuse,
                   decompose_hyper_inds=decompose_hyper_inds,
                   simplify_circuit=simplify_circuit,
                   initial_state=initial_state,
                   final_state=final_state,
                   output_index_token=output_index_token,
                   sparse_index_token=sparse_index_token,
                   atol=atol,
                   dtype=dtype,
                   backend=backend,
                   seed=seed,
                   verbose=verbose)

    if isinstance(obj, Iterator):
        raise NotImplementedError("iterators are not supported.")

    def is_int(x):
        try:
            return int(x) == x
        except (ValueError, TypeError):
            return False

    def is_random_access(x):
        if isinstance(x, Iterator):
            return False
        try:
            len(x)
            x[0]
            return True
        except (TypeError, KeyError, IndexError):
            return False

    def is_matrix(x):
        return (is_random_access(x) and hasattr(x, 'shape') and
                hasattr(x, 'ndim') and x.ndim == 2 and
                x.shape[0] == x.shape[1])

    def is_gate(x):
        return (is_random_access(x) and len(x) == 2 and is_matrix(x[0]) and
                is_random_access(x[1]) and 2**len(x[1]) == x[0].shape[0])

    # TensorNetwork: apply hyper decomposition + fusion transforms
    if isinstance(obj, TensorNetwork):
        return _load_tensor_network(obj, **options)

    if isinstance(obj, str):
        if obj == 'stdin':
            return load_tn(sys.stdin.read().strip(), **options)

        # QASM?
        first_line = next(
            (ln.strip() for ln in obj.splitlines()
             if ln.strip() and not ln.strip().startswith('//')), '')
        if first_line.upper().startswith('OPENQASM'):
            from tnco_tpu_torch.utils.qasm import parse_qasm
            return load_tn(parse_qasm(obj), **options)

        # Index-map text block?
        if obj.strip() and not any(
                re.match(r'^(?=\s*\S)(?!#)(?!\d+(\s+\S+)*\s*$).*', ln)
                for ln in obj.splitlines()):
            rows = []
            for ln in obj.splitlines():
                ln = re.sub(r'\s+', ' ', ln).strip()
                if re.match(r'\d+(\s+\S+)*\s*$', ln):
                    d, *names = ln.split()
                    rows.append((int(d), *names))
            return load_tn(rows, **options)

        # A file?
        try:
            _validate_filepath(obj)
            if Path(obj).expanduser().exists():
                return load_tn(load_file(obj), **options)
        except (ValueError, OSError):
            pass

        # JSON?
        try:
            return load_tn(json.loads(obj), **options)
        except json.JSONDecodeError:
            pass

    if isinstance(obj, dict):
        if 'cirq_type' in obj:
            from cirq import read_json
            return load_tn(read_json(io.StringIO(json.dumps(obj))),
                           **options)

    # List of index rows?
    if (is_random_access(obj) and len(obj) and all(
            is_random_access(x) and len(x) > 1 and is_int(x[0])
            for x in obj)):
        tensor_map, dims, output_inds, sparse_inds = tn_utils.read_inds(
            dict(enumerate(obj)),
            output_index_token=output_index_token,
            sparse_index_token=sparse_index_token)
        return load_tn(
            TensorNetwork(
                (Tensor(xs, tuple(dims[x] for x in xs),
                        tags=dict(name=name))
                 for name, xs in tensor_map.items()),
                output_inds=output_inds,
                sparse_inds=sparse_inds), **options)

    # List of gates?
    if is_random_access(obj) and len(obj) and all(is_gate(x) for x in obj):
        from tnco_tpu_torch.utils.circuit import load

        arrays, ts_inds, output_inds = load(obj,
                                            initial_state=initial_state,
                                            final_state=final_state,
                                            simplify=simplify_circuit,
                                            decompose_hyper_inds=False,
                                            fuse=False,
                                            atol=atol,
                                            dtype=dtype,
                                            backend=backend,
                                            seed=seed,
                                            verbose=verbose)
        return load_tn(
            TensorNetwork(
                (Tensor(xs, array=a) for xs, a in zip(ts_inds, arrays)),
                output_inds=output_inds), **options)

    # Third-party circuits (gated imports)
    mod = type(obj).__module__
    if mod.startswith('cirq.') and type(obj).__name__ in ('Circuit',
                                                          'FrozenCircuit'):
        from tnco_tpu_torch.utils.circuit import cirq_to_gates
        return load_tn(cirq_to_gates(obj), **options)
    if mod.startswith('qiskit.') and type(obj).__name__ == 'QuantumCircuit':
        from tnco_tpu_torch.utils.circuit import qiskit_to_gates
        return load_tn(qiskit_to_gates(obj), **options)

    raise TypeError("'obj' is not recognized.")


def _load_tensor_network(obj: TensorNetwork,
                         *,
                         fuse,
                         decompose_hyper_inds,
                         atol,
                         dtype,
                         backend,
                         seed,
                         verbose,
                         **_unused) -> TensorNetwork:
    """TensorNetwork transforms: hyper decomposition + fusion.

    Reference: tnco/app/app.py:314-423 (provenance stored in
    ``tags['hyper_inds_map'/'fuse_path']``).
    """
    ts_inds = list(obj.ts_inds)
    dims = dict(obj.dims)
    arrays = [
        None if a is None else asarray(a, like=backend, dtype=dtype)
        for a in obj.arrays
    ]
    tags = dict(obj.tags)
    ts_tags = list(obj.ts_tags)
    output_inds = obj.output_inds
    sparse_inds = obj.sparse_inds

    n_provided = sum(a is not None for a in arrays)

    if sparse_inds:
        if decompose_hyper_inds or fuse:
            warn("The decomposition of hyper-indices and the fusion of "
                 "indices is not yet supported if there are sparse indices")
        decompose_hyper_inds = False
        fuse = False

    if n_provided < len(arrays) and decompose_hyper_inds:
        warn("Cannot decompose hyper-indices if not all arrays are "
             "provided.")
        decompose_hyper_inds = False
    if n_provided not in (0, len(arrays)):
        fuse = False

    if decompose_hyper_inds:
        arrays, ts_inds, hyper_inds_map = tn_utils.decompose_hyper_inds(
            arrays, ts_inds, atol=atol)
        output_inds = frozenset(hyper_inds_map[x] for x in output_inds)
        dims = {}
        for a, xs in zip(arrays, ts_inds):
            dims.update(zip(xs, a.shape))
        ts_tags = [None] * len(arrays)
        if 'hyper_inds_map' in tags:
            raise ValueError(
                "'TensorNetwork' has already the tag 'hyper_inds_map'.")
        tags['hyper_inds_map'] = hyper_inds_map

    if fuse is not None and fuse and fuse > 0:
        path = tn_utils.fuse(ts_inds,
                             dims,
                             max_width=fuse,
                             output_inds=output_inds,
                             seed=seed)
        ts_inds, output_inds, *arrays_ = tn_utils.contract(
            path,
            ts_inds,
            output_inds,
            arrays=arrays if n_provided else None,
            dims=dims,
            backend=backend)
        if n_provided:
            arrays = arrays_[0]
        else:
            arrays = [None] * len(ts_inds)

        # Fuse per-tensor tags pairwise along the path
        for (px, py) in (sorted(p) for p in path):
            tags_y = ts_tags.pop(py)
            tags_x = ts_tags.pop(px)
            if tags_x is None and tags_y is None:
                ts_tags.append(None)
            elif tags_x is None:
                ts_tags.append(tags_y)
            elif tags_y is None:
                ts_tags.append(tags_x)
            else:
                ts_tags.append(dict(x=tags_x, y=tags_y))

        if 'fuse_path' in tags:
            raise ValueError(
                "'TensorNetwork' has already the tag 'fuse_path'.")
        tags['fuse_path'] = path

    return TensorNetwork(
        (Tensor(xs,
                dims=tuple(dims[x] for x in xs),
                array=a,
                tags=t) for xs, a, t in zip(ts_inds, arrays, ts_tags)),
        output_inds=output_inds,
        sparse_inds=sparse_inds,
        tags=tags)


def dump_results(tn: TensorNetwork,
                 res: list,
                 *,
                 output_format: str | None = None,
                 output_filename: str | None = None,
                 output_compression: str = 'auto',
                 overwrite_output_file: bool = False,
                 **kwargs) -> Any:
    """Dumps ``(tn, res)`` raw or as JSON, optionally to a compressed file.

    Reference: tnco/app/app.py:573-712 (same knobs and overwrite guard).
    """
    check_only = kwargs.pop('check_only', False)
    if kwargs:
        raise TypeError("Unexpected extra keyword arguments.")

    output_format = 'raw' if output_format is None else str(
        output_format).lower()
    if output_format not in ('raw', 'json'):
        raise ValueError(f'"{output_format=}" not supported.')

    if output_filename:
        _validate_filepath(output_filename)
    output_filename = (None if output_filename is None else
                       Path(output_filename).expanduser())
    if output_filename and not overwrite_output_file and \
            output_filename.exists():
        raise FileExistsError(
            "'{}' already exists. Please use "
            "'overwrite_output_file=True'.".format(output_filename))

    output_compression = str(output_compression).lower()
    if output_compression not in ('auto', 'none', 'bz2', 'gzip'):
        raise ValueError(f'"{output_compression=}" not supported.')
    if output_compression not in ('auto', 'none') and not output_filename:
        raise ValueError(
            "Output can be compressed only if 'output_filename' is "
            "provided.")

    if check_only:
        return None

    output: Any = (tn, res)
    if output_format == 'json':
        output = '{{"tn" : {}, "res" : {}}}'.format(
            tn.to_json(),
            '[' + ', '.join(r.to_json() for r in res) + ']')

    if output_filename:
        suffix = (output_filename.suffix[1:]
                  if output_compression == 'auto' else output_compression)
        if suffix == 'gzip':
            open_, compress_ = gzip.open, True
        elif suffix == 'bz2':
            open_, compress_ = bz2.open, True
        else:
            open_, compress_ = io.open, False

        if isinstance(output, str):
            if compress_:
                output = output.encode()
            with open_(output_filename, 'w') as file_:
                file_.write(output)
            return None
        with open_(output_filename, 'w' if compress_ else 'bw') as file_:
            pickle.dump(output, file_)
        return None

    return output


@dataclass(frozen=True)
class BaseOptimizer:
    """All optimizer knobs, mirrored 1:1 into CLI flags.

    Reference: tnco/app/app.py:715-795.  ``n_jobs`` is kept for parity —
    replicas run as one device batch, so it only caps host threads used in
    path construction.
    """

    max_width: float | None = None
    n_jobs: int = -1
    width_type: str = 'float32'
    cost_type: str = 'float64'
    output_format: str | None = None
    output_filename: str | None = None
    output_compression: str = 'auto'
    overwrite_output_file: bool = False
    atol: float = 1e-5
    dtype: Any | None = None
    backend: str | None = None
    seed: int | None = None
    verbose: int = 0
    # tnco-tpu extension: replica-batch engine selection
    # ('auto' | 'batched' | 'vmapped' | 'native' | 'multiwalk'
    #  | 'walker' | 'sweep' | 'walks').
    engine: str = 'auto'
    # Concurrent walks per replica (multiwalk/walker/walks engines).
    n_walks: int = 8
    # Torch device of the replica batch; None means 'cuda' (the port's
    # device rule: never the CPU unless asked).
    device: Any | None = None

    def optimize(self, *args: Any, **kwargs: Any) -> Any:
        raise NotImplementedError()

    def _load_tn(self, tn, **load_tn_options):
        return load_tn(tn,
                       atol=self.atol,
                       dtype=self.dtype,
                       backend=self.backend,
                       seed=self.seed,
                       verbose=self.verbose,
                       **load_tn_options)

    def _dump_results(self, tn, res, **dump_results_options):
        return dump_results(tn,
                            res,
                            output_format=self.output_format,
                            output_filename=self.output_filename,
                            output_compression=self.output_compression,
                            overwrite_output_file=self.overwrite_output_file,
                            **dump_results_options)

    def __post_init__(self) -> None:
        object.__setattr__(self, 'device', resolve_device(self.device))
        object.__setattr__(self, '_rng', Random(self.seed))
        self._dump_results(None, None, check_only=True)

    def _expand_betas(self, betas, n_steps):
        """Linear beta ramp (reference infinite_memory/sa.py:147-156)."""
        if n_steps is not None:
            if int(n_steps) != n_steps or n_steps <= 0:
                raise ValueError("'n_steps' must be a positive number.")
            n_steps = int(n_steps)
        if isinstance(betas, tuple) and len(betas) == 2:
            if n_steps is None:
                raise ValueError("'n_steps' must be provided if 'betas' "
                                 "has the format '(beta_min, beta_max)'.")
            if betas[0] == betas[1]:
                raise ValueError(
                    "'betas' must use the format '(beta_ini, beta_end)', "
                    "with 'beta_ini != beta_end'.")
            b0, b1 = float(betas[0]), float(betas[1])
            step = (b1 - b0) / n_steps
            betas = [b0 + i * step for i in range(n_steps)]
        else:
            betas = [float(b) for b in betas]
            if n_steps is not None:
                betas = betas[:n_steps]
        return betas


def Optimizer(method: str = 'sa',
              max_width: float | None = None,
              n_jobs: int = -1,
              width_type: str = 'float32',
              cost_type: str = 'float64',
              output_format: str | None = None,
              output_filename: str | None = None,
              output_compression: str = 'auto',
              overwrite_output_file: bool = False,
              atol: float = 1e-5,
              dtype: Any | None = None,
              backend: str | None = None,
              seed: int | None = None,
              verbose: int = 0,
              engine: str = 'auto',
              n_walks: int = 8,
              device: Any | None = None) -> BaseOptimizer:
    """Factory: picks the implementation module by ``method``/``max_width``.

    Reference: tnco/app/app.py:798-878.  ``device=None`` means
    ``'cuda'`` and raises without CUDA; pass ``device='cpu'`` for the
    CPU.
    """
    opts = dict(max_width=max_width,
                n_jobs=n_jobs,
                width_type=width_type,
                cost_type=cost_type,
                output_format=output_format,
                output_filename=output_filename,
                output_compression=output_compression,
                overwrite_output_file=overwrite_output_file,
                atol=atol,
                dtype=dtype,
                backend=backend,
                seed=seed,
                engine=engine,
                n_walks=n_walks,
                verbose=verbose,
                device=device)

    module = 'tnco_tpu_torch.app'
    if max_width is not None and max_width < float('inf'):
        module += '.finite_width'
    else:
        module += '.infinite_memory'
    module = import_module(module + '.' + str(method))
    return module.Optimizer(**opts)

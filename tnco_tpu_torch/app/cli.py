"""Command-line interface (the port's copy of ``tnco_tpu/app/cli.py``).

Mirrors the reference CLI contract (tnco/app/cli.py:27-78, python-fire):
``tnco-tpu-torch optimize <tn> --betas='(0, 100)' --n-steps=100
--n-runs=8 ...`` with every ``Optimizer`` factory knob exposed as a flag
and JSON as the default output format, and ``tnco-tpu-torch sample
<qasm>``.  Built on argparse (fire-free).

``--device`` (default: the card) takes the place of the JAX CLI's
platform selection; without CUDA the command exits non-zero unless
``--device cpu`` is given.  The port has no XLA programs: its CUDA
kernels are built at their first launch into ``build/kernels/``, which
``utils.compile_cache.enable`` names where the JAX CLI enables its
compile cache.
"""

import argparse
import ast
import json
import sys
from typing import Any

from tnco_tpu_torch.app.app import Optimizer
from tnco_tpu_torch.device import resolve_device
from tnco_tpu_torch.utils import compile_cache

__all__ = ['main']


def _literal(value: str) -> Any:
    """Parses python-literal flag values ('(0, 100)', '10', 'None')."""
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def _state(value: str) -> Any:
    """A state token ('0', '1', '+', '-') stays a string; anything else
    (None, a dict of per-qubit states) is a python literal.  (The JAX
    CLI parses the default '0' as the integer 0, which ``load`` refuses
    for circuits.)"""
    return value if value in ('0', '1', '+', '-') else _literal(value)


_DEVICE_HELP = ("Torch device of the optimization: 'cuda' (the default) or "
                "'cpu'.")


def _build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog='tnco-tpu-torch',
        description='Tensor-network contraction optimizer on PyTorch/CUDA.')
    sub = parser.add_subparsers(dest='command', required=True)

    opt = sub.add_parser('optimize', help='Optimize a tensor network.')
    opt.add_argument('tn', help="Tensor network (any load_tn format, or "
                     "'stdin').")
    # optimize() arguments
    opt.add_argument('--betas', type=_literal, required=True,
                     help="Inverse temperatures: '(b0, b1)' ramp or a list.")
    opt.add_argument('--n-steps', type=_literal, default=None)
    opt.add_argument('--n-runs', type=_literal, default=1)
    opt.add_argument('--n-projs', type=_literal, default=None)
    opt.add_argument('--update-slices', type=_literal, default=10,
                     help='Sweeps between reslicing (finite width only).')
    opt.add_argument('--timeout', type=_literal, default=None)
    # load_tn options
    opt.add_argument('--fuse', type=_literal, default=4)
    opt.add_argument('--decompose-hyper-inds', type=_literal, default=True)
    opt.add_argument('--simplify-circuit', type=_literal, default=True)
    opt.add_argument('--initial-state', type=_state, default='0')
    opt.add_argument('--final-state', type=_state, default='0')
    # Optimizer factory knobs (reference app/app.py:798-878)
    opt.add_argument('--method', default='sa')
    opt.add_argument('--max-width', type=_literal, default=None)
    opt.add_argument('--n-jobs', type=_literal, default=-1)
    opt.add_argument('--width-type', default='float32')
    opt.add_argument('--cost-type', default='float64')
    opt.add_argument('--n-walks', type=int, default=8,
                     help='Concurrent walks per replica '
                          '(multiwalk/walker/walks engines).')
    opt.add_argument('--engine', default='auto',
                     help="Replica-batch engine: 'auto' | 'batched' | "
                          "'vmapped' | 'native' | 'multiwalk' "
                          "| 'walker' | 'sweep' | 'walks'.")
    opt.add_argument('--output-format', default='json')
    opt.add_argument('--output-filename', default=None)
    opt.add_argument('--output-compression', default='auto')
    opt.add_argument('--overwrite-output-file', type=_literal,
                     default=False)
    opt.add_argument('--atol', type=_literal, default=1e-5)
    opt.add_argument('--seed', type=_literal, default=None)
    opt.add_argument('--verbose', type=_literal, default=0)
    opt.add_argument('--device', default=None, help=_DEVICE_HELP)

    smp = sub.add_parser('sample',
                         help='Sample bitstrings from a circuit (BGL).')
    smp.add_argument('circuit',
                     help="QASM string/filename, or 'stdin' for QASM.")
    smp.add_argument('--n-samples', type=_literal, default=1)
    smp.add_argument('--betas', type=_literal, default=(0, 50))
    smp.add_argument('--n-steps', type=_literal, default=50)
    smp.add_argument('--n-runs', type=_literal, default=1)
    smp.add_argument('--fuse', type=_literal, default=4)
    smp.add_argument('--simplify-circuit', type=_literal, default=True)
    smp.add_argument('--decompose-hyper-inds', type=_literal, default=True)
    smp.add_argument('--normalize', type=_literal, default=True)
    smp.add_argument('--seed', type=_literal, default=None)
    smp.add_argument('--verbose', type=_literal, default=0)
    smp.add_argument('--device', default=None, help=_DEVICE_HELP)
    return parser


def main(argv=None) -> int:
    # Where the JAX CLI enables its compile cache (changes no setting).
    compile_cache.enable()

    if argv is None:
        argv = sys.argv[1:]
    # Reference-CLI compatibility: python-fire accepts underscore flags
    # (``--max_width``); normalize them to the argparse dash form.
    def _dashed(tok: str) -> str:
        if tok.startswith('--'):
            name, sep, value = tok[2:].partition('=')
            return '--' + name.replace('_', '-') + sep + value
        return tok

    args = _build_parser().parse_args([_dashed(t) for t in argv])
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as exc:
        print(f'tnco-tpu-torch: {exc}', file=sys.stderr)
        return 2

    if args.command == 'optimize':
        optimizer = Optimizer(method=args.method,
                              max_width=args.max_width,
                              n_jobs=args.n_jobs,
                              width_type=args.width_type,
                              cost_type=args.cost_type,
                              output_format=args.output_format,
                              output_filename=args.output_filename,
                              output_compression=args.output_compression,
                              overwrite_output_file=args.
                              overwrite_output_file,
                              atol=args.atol,
                              seed=args.seed,
                              verbose=args.verbose,
                              engine=args.engine,
                              n_walks=args.n_walks,
                              device=device)
        betas = tuple(args.betas) if isinstance(args.betas,
                                                (list, tuple)) else \
            args.betas
        tn = _literal(args.tn) if args.tn != 'stdin' else 'stdin'

        kwargs = dict(betas=betas,
                      n_steps=args.n_steps,
                      n_runs=args.n_runs,
                      n_projs=args.n_projs,
                      timeout=args.timeout,
                      fuse=args.fuse,
                      decompose_hyper_inds=args.decompose_hyper_inds,
                      simplify_circuit=args.simplify_circuit,
                      initial_state=args.initial_state,
                      final_state=args.final_state)
        if args.max_width is not None and args.max_width < float('inf'):
            kwargs['update_slices'] = args.update_slices

        out = optimizer.optimize(tn, **kwargs)
        if out is not None:
            if isinstance(out, str):
                print(out)
            else:
                print(json.dumps(str(out)))
        return 0

    if args.command == 'sample':
        from pathlib import Path

        from tnco_tpu_torch.app.circuit import Sampler
        from tnco_tpu_torch.utils.qasm import parse_qasm

        text = args.circuit
        if text == 'stdin':
            text = sys.stdin.read()
        elif Path(text).expanduser().is_file():
            text = Path(text).expanduser().read_text()
        gates = parse_qasm(text)

        sampler = Sampler(seed=args.seed, verbose=args.verbose,
                          device=device)
        hits, qubits = sampler.sample(
            gates,
            n_samples=args.n_samples,
            fuse=args.fuse,
            simplify=args.simplify_circuit,
            decompose_hyper_inds=args.decompose_hyper_inds,
            normalize=args.normalize,
            betas=tuple(args.betas) if isinstance(args.betas,
                                                  (list, tuple)) else
            args.betas,
            n_steps=args.n_steps,
            n_runs=args.n_runs)
        print(json.dumps({'qubits': [repr(q) for q in qubits],
                          'hits': hits}))
        return 0
    return 1


if __name__ == '__main__':
    sys.exit(main())

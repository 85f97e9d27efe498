"""The benchmark's command: one run of one cell on the card.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout.  It prints one JSON line as the last line
of its standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, ``spans``
(the program's stage spans) and ``counts`` (its counters over the traced
chunks), and last ``checks``, each number the check compared beside its
limit; the same numbers are the last lines of its standard error.  It
exits with 2 and prints no result when there is no CUDA card (it never
falls back to the CPU), and with 3 when JAX or the JAX package has been
loaded.

The program's kernels build into ``build/`` inside the checkout, so only
the first run there compiles; the caches of CUDA's own compilers are
pointed there too.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
from pathlib import Path  # noqa: E402
import sys  # noqa: E402

_ROOT = Path(__file__).resolve().parents[1]


def _cache_dirs() -> None:
    """Every compiler cache at a fixed path inside the checkout."""
    build = _ROOT / 'build'
    for var, sub in (('TRITON_CACHE_DIR', 'triton'),
                     ('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                     ('CUDA_CACHE_PATH', 'cuda_cache')):
        os.environ[var] = str(build / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog='portbench.run')
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()

    import torch
    from portbench import harness, spec

    chips = next(w['chips'] for w in spec.load()['workloads']
                 if w['name'] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'portbench: the cell needs {chips} CUDA card(s); '
              f'{torch.cuda.device_count()} found.', file=sys.stderr)
        return 2
    out = harness.execute(args.workload, args.seed, args.seconds,
                          bool(args.trace), t0=T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f'portbench: the run loaded {bad}, which no run may load.',
              file=sys.stderr)
        return 3
    print(f"correct: {str(out['correct']).lower()}", file=sys.stderr)
    for name, c in out['checks'].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

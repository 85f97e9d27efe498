#!/usr/bin/env python3
"""The largest float64 total gap between the port and the JAX package.

Runs ``tests/test_torch_float64.py`` on the CPU with a pytest plugin
that wraps the file's ``compare`` helper and records, for every total
(``log2_total``, ``min_log2_total``) it compares against JAX under x64,
the largest |port - JAX|.  Prints the largest gap and the number of
comparisons; the tests hold every gap under their ``TOTAL_ATOL64``.

Run from the repository root:

    JAX_PLATFORMS=cpu python3 scripts/float64_gap.py
"""

from pathlib import Path
import sys

import numpy as np
import pytest

_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(_ROOT))
_TOTALS = ('log2_total', 'min_log2_total')


class GapPlugin:
    def __init__(self):
        self.gaps = []

    def pytest_collection_modifyitems(self, session, config, items):
        mod = items[0].module
        compare = mod.compare

        def recorded(ref, got, what, atol=1e-5, margins=None):
            if atol:                       # the comparisons against JAX
                for k in _TOTALS:
                    if k in ref:
                        d = np.abs(np.asarray(got[k], np.float64) -
                                   np.asarray(ref[k], np.float64))
                        d = d[np.isfinite(d)]
                        if d.size:
                            self.gaps.append(float(d.max()))
            return compare(ref, got, what, atol=atol, margins=margins)

        mod.compare = recorded


def main() -> int:
    plugin = GapPlugin()
    rc = pytest.main([str(_ROOT / 'tests' / 'test_torch_float64.py'), '-q',
                      '-p', 'no:cacheprovider'], plugins=[plugin])
    if plugin.gaps:
        print(f'largest float64 total gap against JAX: {max(plugin.gaps):.3e}'
              f' over {len(plugin.gaps)} comparisons')
    return int(rc)


if __name__ == '__main__':
    sys.exit(main())

"""Runs every docstring example of the port, as ``tests/test_doctests.py``
runs the JAX package's (reference CI parity: ``pytest --doctest-modules``).
The port's examples run on the CPU (no example reaches a card)."""

import doctest
import importlib
import pkgutil

import pytest

import tnco_tpu_torch


def _modules():
    for info in pkgutil.walk_packages(tnco_tpu_torch.__path__,
                                      prefix='tnco_tpu_torch.'):
        yield info.name


@pytest.mark.parametrize('name', sorted(_modules()))
def test_doctests(name):
    module = importlib.import_module(name)
    results = doctest.testmod(module, verbose=False)
    assert results.failed == 0, f'{results.failed} doctest failures in {name}'

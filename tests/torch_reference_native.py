"""A private build of the JAX package's native library for the port's
parity tests.

``tnco_tpu.native`` compiles ``_tnco_native.so`` in place beside its
source, with no lock across processes, and a process that once fails to
load it keeps None for its life.  Test workers that build it at once can
lose that race: the JAX trees then validate in numpy, the JAX runners'
'auto' rule no longer sees the library, and ``jnative`` returns None.
Every port test file that reaches the reference's library imports the
fixture below, which points the reference loader at a library built by
the reference's own g++ command from the same ``core.cpp`` into pytest's
temporary directory (once a process), for the duration of the module,
and restores the loader's state afterwards.  The shared file is never
written: every build the reference starts meanwhile is recorded, and
``tests/test_torch_native.py`` holds the record to the private path.
"""

from pathlib import Path

import pytest

from tnco_tpu import native as jnative

# The reference's shared library, which the port's tests never write.
SHARED_LIB = Path(jnative.__file__).parent / '_tnco_native.so'

# The private library's path (one a process) and every path the
# reference's ``_build`` was asked to write while a module held the
# fixture.
_PRIVATE: list[Path] = []
BUILD_TARGETS: list[Path] = []


def private_lib(tmp_path_factory) -> Path:
    """The process's private library path (not built yet at first)."""
    if not _PRIVATE:
        _PRIVATE.append(
            tmp_path_factory.mktemp('reference_native') / SHARED_LIB.name)
    return _PRIVATE[0]


@pytest.fixture(scope='module', autouse=True)
def reference_native(tmp_path_factory):
    """The reference loader on the private library for one module."""
    build = jnative._build

    def recorded_build():
        BUILD_TARGETS.append(Path(jnative._LIB_PATH))
        return build()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, '_build', recorded_build)
        mp.setattr(jnative, '_LIB_PATH', private_lib(tmp_path_factory))
        mp.setattr(jnative, '_LIB', None)
        mp.setattr(jnative, '_TRIED', False)
        assert jnative.available(), (
            'the private build of tnco_tpu/native/core.cpp did not load')
        yield jnative

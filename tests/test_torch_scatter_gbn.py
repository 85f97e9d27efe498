"""K4, the out-of-place row scatter: the port's plain route == the JAX
``scatter_rows_gbn``, bitwise.

The JAX side runs as its own tests run it on the CPU: the Pallas kernel
in interpret mode (the wide body ``_scatter_kernel_wide``; the tiled body
``_scatter_kernel`` once, at the smallest shape that selects it, which
interpret mode runs in about 2 s) and the XLA path (``interpret=None``:
``_scatter_xla`` with the XLA inversion on the CPU).  Duplicate ids are
compared with interpret mode only: the TPU kernel keeps the last q, the
XLA inversion leaves their order undefined.  B and N are not multiples
of 8 and 128, so the JAX padding is crossed.  The CUDA kernel runs only
on the card (``-m cuda``; skipped elsewhere).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tnco_tpu.kernels import pallas_scatter as ps
from tnco_tpu_torch.kernels import scatter as ks
from torch_reference_native import reference_native  # noqa: F401

_SPECIALS = np.asarray([0x7FC12345, 0x7F800001, 0xFF800000, 0x80000000,
                        0x7FFFFFFF], dtype=np.uint32)  # NaNs, -inf, -0


def _vals(r, shape, dtype):
    x = r.integers(0, 2**32, shape, dtype=np.uint32).reshape(-1)
    k = min(x.size, len(_SPECIALS))
    x[:k] = _SPECIALS[:k]
    return x.reshape(shape).view(dtype)


def _ids(r, b, n, q, dup=False):
    """Per-row unique in-range ids, with NULL (-1) and ids >= n mixed in;
    ``dup``: the second half of each row repeats the first."""
    ids = np.stack([r.choice(n, q, replace=False) for _ in range(b)])
    ids = ids.astype(np.int32)
    x = r.random((b, q))
    ids[x < 0.1] = -1
    ids[x > 0.95] = n + 5
    if dup:
        ids[:, q // 2:] = ids[:, :q - q // 2]
    return ids


def _torch(x):
    x = np.ascontiguousarray(x)
    if x.dtype == np.uint32:
        x = x.view(np.int32)
    return torch.from_numpy(x.copy())


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    return np.asarray(x).view(np.uint32)


def _jax(vals, ids, upd, planes, interpret):
    return ps.scatter_rows_gbn(jnp.asarray(vals), jnp.asarray(ids),
                               jnp.asarray(upd), planes=planes,
                               interpret=interpret)


@pytest.mark.parametrize('dtype', ['int32', 'uint32', 'float32'])
@pytest.mark.parametrize('planes', [None, (1, 4), (3, 4)])
def test_scatter_gbn_plain_matches_jax(random_seed, dtype, planes):
    r = np.random.default_rng(random_seed)
    g, b, n, q = 4, 6, 200, 70
    lo, hi = (0, g) if planes is None else planes
    vals = _vals(r, (g, b, n), dtype)
    upd = _vals(r, (hi - lo, b, q), dtype)
    ids = _ids(r, b, n, q)
    got = ks.scatter_rows_gbn(_torch(vals), _torch(ids), _torch(upd),
                              planes=planes)
    assert got.dtype == _torch(vals).dtype
    assert got.shape == (hi - lo, b, n)
    for interpret in (True, None):      # the Pallas wide body, then XLA
        np.testing.assert_array_equal(
            _bits(got), _bits(_jax(vals, ids, upd, planes, interpret)),
            err_msg=f'interpret={interpret}')


@pytest.mark.parametrize('planes', [None, (0, 2), (2, 3)])
def test_scatter_gbn_duplicates_last_q_wins(random_seed, planes):
    r = np.random.default_rng(random_seed)
    g, b, n, q = 3, 9, 130, 40
    lo, hi = (0, g) if planes is None else planes
    vals = _vals(r, (g, b, n), 'int32')
    upd = _vals(r, (hi - lo, b, q), 'int32')
    ids = _ids(r, b, n, q, dup=True)
    got = ks.scatter_rows_gbn(_torch(vals), _torch(ids), _torch(upd),
                              planes=planes)
    np.testing.assert_array_equal(_bits(got),
                                  _bits(_jax(vals, ids, upd, planes, True)))


def test_scatter_gbn_tiled_body_matches_jax(random_seed):
    """The tiled Pallas body, taken when ``b_pad * n_pad * 4 * 5`` exceeds
    16 MB: B=57 (padded to 64) and N=13100 (padded to 13184) is the
    smallest such shape at B=57."""
    r = np.random.default_rng(random_seed)
    g, b, n, q = 2, 57, 13100, 70
    b_pad, n_pad = -(-b // 8) * 8, -(-n // 128) * 128
    assert b_pad * n_pad * 4 * 5 > 16 * 1024 * 1024
    vals = _vals(r, (g, b, n), 'float32')
    upd = _vals(r, (1, b, q), 'float32')
    ids = _ids(r, b, n, q)
    got = ks.scatter_rows_gbn(_torch(vals), _torch(ids), _torch(upd),
                              planes=(1, 2))
    np.testing.assert_array_equal(_bits(got),
                                  _bits(_jax(vals, ids, upd, (1, 2), True)))


@pytest.mark.parametrize('shape', [(2, 1, 7, 1), (3, 5, 11, 0),
                                   (1, 4, 1, 3), (2, 3, 9, 9)])
def test_scatter_gbn_edge_shapes(random_seed, shape):
    """One replica and one id; no ids; N=1; every column addressed."""
    r = np.random.default_rng(random_seed)
    g, b, n, q = shape
    vals = _vals(r, (g, b, n), 'int32')
    upd = _vals(r, (g, b, q), 'int32')
    ids = np.stack([r.permutation(n)[:q] if q <= n else
                    r.integers(-1, n, q) for _ in range(b)])
    ids = ids.astype(np.int32).reshape(b, q)
    got = ks.scatter_rows_gbn(_torch(vals), _torch(ids), _torch(upd))
    if q == 0:
        np.testing.assert_array_equal(_bits(got), _bits(vals))
    else:
        np.testing.assert_array_equal(_bits(got),
                                      _bits(_jax(vals, ids, upd, None, True)))


def test_scatter_gbn_leaves_the_callers_tensor(random_seed):
    r = np.random.default_rng(random_seed)
    vals = _torch(_vals(r, (3, 5, 40), 'float32'))
    ids = _torch(_ids(r, 5, 40, 12))
    upd = _torch(_vals(r, (3, 5, 12), 'float32'))
    before = vals.clone()
    got = ks.scatter_rows_gbn(vals, ids, upd)
    assert got.data_ptr() != vals.data_ptr()
    assert torch.equal(vals.view(torch.int32), before.view(torch.int32))
    # the in-place scatter computes the same planes on its own tensor
    inplace = ks.scatter_rows_inplace(vals.clone(), ids, upd)
    assert torch.equal(inplace.view(torch.int32), got.view(torch.int32))


def test_scatter_gbn_rejects_bad_inputs():
    vals = torch.zeros((3, 2, 5), dtype=torch.int32)
    ids = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match='upd shape'):
        ks.scatter_rows_gbn(vals, ids, torch.zeros((3, 2, 4),
                                                   dtype=torch.int32),
                            planes=(1, 3))
    with pytest.raises(ValueError, match='dtype'):
        ks.scatter_rows_gbn(vals, ids, torch.zeros((3, 2, 4)))
    with pytest.raises(ValueError, match='planes'):
        ks.scatter_rows_gbn(vals, ids, torch.zeros((3, 2, 4),
                                                   dtype=torch.int32),
                            planes=(2, 5))


@pytest.mark.cuda
@pytest.mark.parametrize('planes', [None, (2, 5)])
def test_scatter_gbn_kernel_matches_plain_on_card(random_seed, planes):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the CUDA kernels have no CPU '
                    'mode); run python3 chip_smoke.py on the card')
    r = np.random.default_rng(random_seed)
    dev = torch.device('cuda')
    g, b, n, q = 6, 64, 3241, 256
    lo, hi = (0, g) if planes is None else planes
    vals = _torch(_vals(r, (g, b, n), 'float32')).to(dev)
    upd = _torch(_vals(r, (hi - lo, b, q), 'float32')).to(dev)
    for dup in (False, True):
        ids = _torch(_ids(r, b, n, q, dup)).to(dev)
        before = vals.clone()
        got = ks.scatter_rows_gbn(vals, ids, upd, planes=planes)
        want = ks.scatter_rows_gbn_plain(vals, ids, upd, planes)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert torch.equal(vals.view(torch.int32), before.view(torch.int32))

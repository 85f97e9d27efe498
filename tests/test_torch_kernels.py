"""Port kernels K1-K3: plain versions == the JAX kernels, bitwise.

The JAX side runs as its own tests run it on the CPU: the XLA lowering
and the Pallas kernel in interpret mode (the reference for the
last-q-wins rule on duplicate ids).  The wrappers' route choice is a
function of the shape, tested here.  The CUDA kernels themselves run
only on the card (``-m cuda``; skipped elsewhere): every route against
the plain version at the cases of ``tnco_tpu_torch.testing.kernel_cases``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tnco_tpu.kernels import pallas_gather as pg
from tnco_tpu.kernels import pallas_scatter as ps
from tnco_tpu_torch.kernels import build, launch_counts, reset_launch_counts
from tnco_tpu_torch.kernels import gather as kg
from tnco_tpu_torch.kernels import scatter as ks
from tnco_tpu_torch.testing import kernel_cases as kc
from torch_reference_native import reference_native  # noqa: F401

_SPECIALS = np.asarray([0x7FC00000, 0xFF800000, 0x7F800000, 0x80000000,
                        0x7F800001], dtype=np.uint32)  # NaN -inf inf -0 sNaN


def _vals(r, shape, dtype):
    x = r.integers(0, 2**32, shape, dtype=np.uint32)
    x.reshape(-1)[:len(_SPECIALS)] = _SPECIALS
    return x.view(dtype)


def _ids(r, b, q, n):
    """Ids with -1, >= n and in-range entries (duplicates allowed)."""
    ids = r.integers(-1, n + 3, (b, q)).astype(np.int32)
    ids[:, 0] = -1
    if q > 1:
        ids[:, 1] = n
    return ids


def _unique_ids(r, b, n, q):
    ids = np.full((b, q), -1, np.int32)
    for i in range(b):
        k = int(r.integers(0, min(q, n) + 1))
        ids[i, :k] = r.choice(n, size=k, replace=False)
        r.shuffle(ids[i])
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


@pytest.mark.parametrize('dtype', ['int32', 'uint32', 'float32'])
@pytest.mark.parametrize('planes', [None, (1, 3), (2, 3)])
def test_gather_plain_matches_jax(random_seed, dtype, planes):
    r = np.random.default_rng(random_seed)
    g, b, n, q = 3, 8, 200, 130
    vals = _vals(r, (g, b, n), dtype)
    ids = _ids(r, b, q, n)
    want = pg.gather_gbn(jnp.asarray(vals), jnp.asarray(ids), planes=planes)
    want_pl = pg.gather_gbn(jnp.asarray(vals), jnp.asarray(ids),
                            planes=planes, interpret=True)
    got = kg.gather_gbn(_torch(vals), _torch(ids), planes=planes)
    assert got.dtype == _torch(vals).dtype
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(want_pl))


def test_gather_bn_matches_jax(random_seed):
    r = np.random.default_rng(random_seed)
    vals = _vals(r, (5, 300), 'int32')
    ids = _ids(r, 5, 64, 300)
    want = pg.gather_bn(jnp.asarray(vals), jnp.asarray(ids))
    got = kg.gather_bn(_torch(vals), _torch(ids))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize('dup', [False, True])
def test_inv_ids_plain_matches_jax(random_seed, dup):
    r = np.random.default_rng(random_seed)
    b, n, q = 8, 260, 140
    if dup:
        ids = _ids(r, b, q, n)
        ids[:, 70:] = ids[:, :70]          # duplicates: last q wins
    else:
        ids = _unique_ids(r, b, n, q)
    want = ps.inv_ids(jnp.asarray(ids), n, interpret=True)
    got = ks.inv_ids(_torch(ids), n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if not dup:
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(ps.inv_ids(jnp.asarray(ids), n)))


@pytest.mark.parametrize('kind', ['dup', 'q>n'])
@pytest.mark.parametrize('n', [1, 33, 1025, 2051])
def test_inv_ids_plain_matches_jax_slices(random_seed, n, kind):
    """K2's plain version against the interpret-mode Pallas kernel at n
    of one word, ragged ones, and one just above the card kernel's slice
    (INV_SLICE + 3), with duplicate ids, with Q > n, and with -1,
    out-of-range and extreme ids."""
    r = np.random.default_rng(random_seed)
    b, q = 8, (140 if kind == 'dup' else n + 37)
    ids = _ids(r, b, q, n)
    if kind == 'dup':
        ids[:, q // 2:] = ids[:, :q - q // 2]
    ids[:, 2] = -2**31
    ids[:, 3] = 2**31 - 1
    want = ps.inv_ids(jnp.asarray(ids), n, interpret=True)
    got = ks.inv_ids(_torch(ids), n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('n,slices', [
    (1, 1), (ks.INV_SLICE - 1, 1), (ks.INV_SLICE, 1), (ks.INV_SLICE + 1, 2),
    (3328, 2), (20000, 10)])
def test_inv_slices(n, slices):
    """K2 runs one block per (replica, INV_SLICE columns) for every n."""
    assert ks.INV_SLICE == 2048
    assert ks.inv_slices(n) == slices


@pytest.mark.parametrize('dtype', ['int32', 'uint32', 'float32'])
@pytest.mark.parametrize('planes,dup', [(None, False), ((2, 5), False),
                                        ((0, 3), True), ((4, 5), True)])
def test_scatter_inplace_plain_matches_jax(random_seed, dtype, planes, dup):
    r = np.random.default_rng(random_seed)
    g_all, b, n, q = 5, 8, 256, 96
    lo, hi = (0, g_all) if planes is None else planes
    vals = _vals(r, (g_all, b, n), dtype)
    upd = _vals(r, (hi - lo, b, q), dtype)
    ids = _unique_ids(r, b, n, q)
    if dup:
        ids[:, q // 2:] = ids[:, :q - q // 2]
        ids[:, 3] = n + 1
    want = ps.scatter_rows_inplace(jnp.asarray(vals), jnp.asarray(ids),
                                   jnp.asarray(upd), planes=planes,
                                   interpret=True)
    tv = _torch(vals)
    got = ks.scatter_rows_inplace(tv, _torch(ids), _torch(upd),
                                  planes=planes)
    assert got is tv                                        # in place
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if not dup:
        auto = ps.scatter_rows_inplace(jnp.asarray(vals), jnp.asarray(ids),
                                       jnp.asarray(upd), planes=planes)
        np.testing.assert_array_equal(_bits(got), _bits(auto))


def test_plain_versions_do_not_count_launches():
    reset_launch_counts()
    vals = torch.zeros((2, 3, 4), dtype=torch.int32)
    ids = torch.zeros((3, 2), dtype=torch.int32)
    kg.gather_gbn(vals, ids)
    ks.scatter_rows_inplace(vals, ids, torch.ones((2, 3, 2),
                                                  dtype=torch.int32))
    ks.scatter_rows_gbn(vals, ids, torch.ones((2, 3, 2), dtype=torch.int32))
    assert launch_counts() == {'gather_gbn': 0, 'inv_ids': 0,
                               'scatter_rows_inplace': 0,
                               'scatter_rows_gbn': 0, 'walker_im': 0,
                               'walker_fw': 0, 'probe_loop': 0,
                               'probe_take': 0, 'claim_disjoint': 0}


def test_recorded_cases(monkeypatch):
    """``recorded_cases`` keeps one case per distinct launch shape, passes
    each launch on, and puts the launchers back."""
    calls = []
    monkeypatch.setattr(kg, '_launch', lambda *a: calls.append('K1'))
    monkeypatch.setattr(ks, '_launch_scatter',
                        lambda *a: calls.append('K3'))
    vals = torch.zeros((7, 3, 5), dtype=torch.int32)
    ids = torch.zeros((3, 2), dtype=torch.int32)
    with kc.recorded_cases() as seen:
        for _ in range(2):
            kg._launch(vals, ids, torch.empty((4, 3, 2)), 1, 'sparse')
        kg._launch(vals.float(), ids, torch.empty((7, 3, 2)), 0, 'row')
        ks._launch_scatter(vals, ids[:, :1], None, 2, 3, 'smem')
    assert calls == ['K1', 'K1', 'K1', 'K3']
    assert kg._launch.__name__ == '<lambda>'
    assert ks._launch_scatter.__name__ == '<lambda>'
    assert {(c[1:], d) for c, d in seen} == {
        ((7, 3, 5, (1, 5), 2, 'sparse'), torch.int32),
        ((7, 3, 5, (0, 7), 2, 'row'), torch.float32),
        ((7, 3, 5, (2, 3), 1, False, 'smem'), torch.int32)}


@pytest.mark.parametrize('case', ['meta', 'ids_dtype', 'rows', 'planes',
                                  'upd_shape', 'itemsize'])
def test_wrappers_reject_bad_inputs(case):
    vals = torch.zeros((2, 3, 4), dtype=torch.int32)
    ids = torch.zeros((3, 2), dtype=torch.int32)
    upd = torch.zeros((2, 3, 2), dtype=torch.int32)
    kw = {}
    if case == 'meta':
        vals, ids, upd = (x.to('meta') for x in (vals, ids, upd))
    elif case == 'ids_dtype':
        ids = ids.long()
    elif case == 'rows':
        ids = torch.zeros((4, 2), dtype=torch.int32)
    elif case == 'planes':
        kw = {'planes': (1, 3)}
    elif case == 'upd_shape':
        upd = torch.zeros((1, 3, 2), dtype=torch.int32)
    elif case == 'itemsize':
        vals = vals.double()
    with pytest.raises(ValueError):
        if case in ('upd_shape',):
            ks.scatter_rows_inplace(vals, ids, upd)
        else:
            kg.gather_gbn(vals, ids, **kw)
    if case == 'meta':
        with pytest.raises(ValueError):
            ks.inv_ids(ids, 4)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """On a host without nvcc the CUDA kernels cannot be built: the
    builder raises instead of carrying on."""
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    monkeypatch.setenv('PATH', str(tmp_path))
    monkeypatch.setattr(build, '_lib', None)
    monkeypatch.setattr(build, 'BUILD_DIR', tmp_path / 'kernels')
    with pytest.raises(RuntimeError, match='nvcc'):
        build.load()


def _case_id(case):
    if isinstance(case, str):
        return case
    return f"{'K1' if isinstance(case, kc.GatherCase) else 'K3'} {case.name}"


@pytest.mark.parametrize('case', kc.GATHER_CASES + kc.SCATTER_CASES,
                         ids=_case_id)
def test_route_is_a_function_of_the_shape(case):
    """The wrappers pick a kernel route from (N, Q) alone, and the kernel
    takes that route at the shape."""
    if isinstance(case, kc.GatherCase):
        route = kg.gather_route(case.n, case.q)
        assert route in kc.gather_routes(case.n, case.q)
    else:
        route = ks.scatter_route(case.n, case.q)
        assert route in kc.scatter_routes(case.n, case.q)
    assert route == case.route


def test_gather_route_thresholds():
    """Rows of at most ROW_MAX_N words read at Q >= ROW_MIN_Q ids go to
    the row route; wider rows or fewer reads to the sparse one."""
    n, q = kg.ROW_MAX_N, kg.ROW_MIN_Q
    assert kg.gather_route(n, q) == 'row'
    assert kg.gather_route(1, q) == 'row'
    assert kg.gather_route(n + 1, 10 * q) == 'sparse'
    assert kg.gather_route(n, q - 1) == 'sparse'
    assert ks.scatter_route(3328, 256) == 'smem'
    assert ks.scatter_route(20000, 777) == 'global'


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.int32, torch.float32],
                         ids=['int32', 'float32'])
@pytest.mark.parametrize('case', kc.GATHER_CASES + kc.SCATTER_CASES +
                         ('inv_ids',),
                         ids=_case_id)
def test_kernels_match_plain_on_card(random_seed, case, dtype):
    """Every route of K1 and K3 (and K2, dtype aside) against the plain
    version, bitwise, at the cases of
    ``tnco_tpu_torch.testing.kernel_cases``."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the CUDA kernels have no CPU '
                    'mode); run python3 chip_smoke.py on the card')
    dev = torch.device('cuda')
    if case == 'inv_ids':
        bad = [c.name for c in kc.INV_CASES
               if kc.check_inv(c, dev, seed=random_seed)]
        assert bad == []
        return
    check = kc.check_gather if isinstance(case, kc.GatherCase) else \
        kc.check_scatter
    assert check(case, dtype, dev, seed=random_seed) == []

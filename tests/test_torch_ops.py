"""Port ops vs the JAX package on the same numpy inputs.

Integer results (popcounts, popcount widths, slice-free bit-plane widths
of power-of-two dims) are compared bitwise.  Sums of the same f32 terms
in the same pinned pairwise order are bitwise too.  ``exp2``/``log2``
differ between XLA and torch, so totals carry a float bound: over these
inputs the two agree within 1 ulp of the total (<= 7.7e-6 in log2 below
128), and the tests hold them to 1e-5 absolute in log2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tnco_tpu.kernels import sa_finite_batched as jsfb
from tnco_tpu.kernels import sa_fullsweep as jsfs
from tnco_tpu.ops import bitops as jbit
from tnco_tpu.ops import costs as jcost
from tnco_tpu_torch.kernels import sa_finite_batched as tsfb
from tnco_tpu_torch.kernels import sa_fullsweep as tsfs
from tnco_tpu_torch.ops import bitops as tbit
from tnco_tpu_torch.ops import costs as tcost
from torch_reference_native import reference_native  # noqa: F401

TOTAL_ATOL = 1e-5  # log2 units; the measured gap is <= 1 ulp


def _words(r, shape):
    return r.integers(0, 2**32, shape, dtype=np.uint32)


def _t(x):
    x = np.ascontiguousarray(x)
    return torch.from_numpy((x.view(np.int32) if x.dtype == np.uint32
                             else x).copy())


def test_popcount32_matches_bit_count(random_seed):
    r = np.random.default_rng(random_seed)
    w = _words(r, (4096,))
    w[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    want = np.asarray(jax.lax.population_count(jnp.asarray(w)))
    got = tbit.popcount32(_t(w)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int32))
    np.testing.assert_array_equal(
        got, np.asarray([int(x).bit_count() for x in w]))


@pytest.mark.parametrize('n', [1, 5, 64, 100])
def test_pairwise_sums_bitwise(random_seed, n):
    r = np.random.default_rng(random_seed)
    x = r.standard_normal((n, 7)).astype(np.float32) * 1e3
    np.testing.assert_array_equal(
        tcost.pairwise_sum(torch.from_numpy(x)).numpy(),
        np.asarray(jcost.pairwise_sum(jnp.asarray(x))))
    np.testing.assert_array_equal(
        tbit.pairwise_sum_last(torch.from_numpy(x.T.copy())).numpy(),
        np.asarray(jbit.pairwise_sum_last(jnp.asarray(x.T))))


def test_pad_log2_dims_and_device_dtype():
    log2d = np.log2([2, 3, 4, 5])
    got = tbit.pad_log2_dims(log2d, 2).numpy()
    want = np.asarray(jbit.pad_log2_dims(log2d, 2))
    np.testing.assert_array_equal(got, want)
    assert tbit.device_dtype('float64') == torch.float32
    assert tbit.device_dtype('float32') == torch.float32
    # Under the float64 mode (the counterpart of JAX's x64 flag) the wide
    # tags give float64, as the JAX rule does under x64.
    with tbit.enable_float64():
        assert tbit.device_dtype('float64') == torch.float64
        assert tbit.device_dtype('float32') == torch.float32
    assert tbit.device_dtype('float64') == torch.float32


@pytest.mark.parametrize('last', [False, True])
def test_log2_total_from_lcc(random_seed, last):
    r = np.random.default_rng(random_seed)
    lcc = (r.random((300, 16)) * 80 - 10).astype(np.float32)
    lcc[150:] = np.where(r.random((150, 16)) < 0.3, -np.inf, lcc[150:])
    if last:
        want = jcost.log2_total_from_lcc_last(jnp.asarray(lcc.T), 20)
        got = tcost.log2_total_from_lcc_last(torch.from_numpy(lcc.T.copy()),
                                             20)
    else:
        want = jcost.log2_total_from_lcc(jnp.asarray(lcc), 20)
        got = tcost.log2_total_from_lcc(torch.from_numpy(lcc), 20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOTAL_ATOL)
    single = tcost.log2_total_from_lcc(torch.from_numpy(lcc[:1]), 1)
    assert torch.isneginf(single).all()


def test_new_total_log2(random_seed):
    r = np.random.default_rng(random_seed)
    n = 4000
    lt = (r.random(n) * 60 + 10).astype(np.float32)
    la = lt - 1 - (r.random(n) * 20).astype(np.float32)
    lb = lt - 1 - (r.random(n) * 20).astype(np.float32)
    na = lt - (r.random(n) * 20).astype(np.float32)
    nb = lt - (r.random(n) * 20).astype(np.float32)
    args = (lt, la, lb, na, nb)
    want = jcost.new_total_log2(*(jnp.asarray(x) for x in args))
    got = tcost.new_total_log2(*(torch.from_numpy(x) for x in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOTAL_ATOL)


@pytest.mark.parametrize('uniform', [True, False])
def test_width_bn_matches_jax(random_seed, uniform):
    r = np.random.default_rng(random_seed)
    w = 3
    lanes = _words(r, (w, 5, 7))
    if uniform:
        log2d = np.full(w * 32, 1.0, np.float32)
        ul = 1.0
    else:
        log2d = np.log2(r.integers(2, 6, w * 32)).astype(np.float32)
        ul = None
    ld = log2d.reshape(w, 32)
    want = jsfs._width_bn(jnp.asarray(lanes), jnp.asarray(ld), ul,
                          jnp.float32)
    got = tsfs._width_bn(_t(lanes), torch.from_numpy(ld), ul, torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('word_axis', [0, 1])
def test_pc_width_matches_jax(random_seed, word_axis):
    r = np.random.default_rng(random_seed)
    lanes = _words(r, (6, 4, 9) if word_axis == 0 else (9, 6, 4))
    want = jsfb._pc_width(jnp.asarray(lanes), 2.0, jnp.float32, None, None,
                          word_axis=word_axis)
    got = tsfb._pc_width(_t(lanes), 2.0, torch.float32, word_axis=word_axis)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_uniform_log2_dim():
    assert tsfs.uniform_log2_dim(np.log2([2, 2, 2])) == 1.0
    assert tsfs.uniform_log2_dim(np.log2([2, 4])) is None
    assert tsfs.uniform_log2_dim([]) == 0.0


@pytest.mark.parametrize('dims', ['dim2', 'mixed'])
def test_expand_bits_width_and_ccost(random_seed, dims):
    """``expand_bits``, ``width`` and ``ccost_log2`` (item 2's part that
    the lockstep engines use) against the JAX functions: the 0/1
    expansion bitwise, widths bitwise (the same pinned pairwise order
    over exact products)."""
    r = np.random.default_rng(random_seed)
    w = 3
    lanes = _words(r, (17, w))
    n_inds = 80
    log2d = (np.ones(n_inds) if dims == 'dim2' else
             np.log2(r.integers(2, 6, n_inds)))
    jl = jbit.pad_log2_dims(log2d, w)
    tl = tbit.pad_log2_dims(log2d, w)
    np.testing.assert_array_equal(
        tbit.expand_bits(_t(lanes)).numpy(),
        np.asarray(jbit.expand_bits(jnp.asarray(lanes))))
    want = np.asarray(jbit.width(jnp.asarray(lanes), jl))
    np.testing.assert_array_equal(tbit.width(_t(lanes), tl).numpy(), want)
    np.testing.assert_array_equal(
        tcost.ccost_log2(_t(lanes), tl).numpy(),
        np.asarray(jcost.ccost_log2(jnp.asarray(lanes), jl)))
    # Sparse indices: the dense part plus min(sparse part, log2 n_projs),
    # equal to JAX's at caps below, within and above the sparse widths.
    for cap in (0.5, 2.0, 7.0, 40.0):
        np.testing.assert_array_equal(
            tcost.ccost_log2(_t(lanes), tl, sparse_lanes=_t(lanes[0]),
                             log2_n_projs=np.float32(cap)).numpy(),
            np.asarray(jcost.ccost_log2(jnp.asarray(lanes), jl,
                                        sparse_lanes=jnp.asarray(lanes[0]),
                                        log2_n_projs=np.float32(cap))))


def test_mh_log2_accept(random_seed):
    r = np.random.default_rng(random_seed)
    log2_u = np.log2(r.random(256).astype(np.float32))
    l_old = r.uniform(40, 60, 256).astype(np.float32)
    l_new = l_old + r.normal(0, 0.5, 256).astype(np.float32)
    beta = np.float32(3.0)
    want = np.asarray(jcost.mh_log2_accept(
        jnp.asarray(log2_u), beta, jnp.asarray(l_new), jnp.asarray(l_old)))
    got = tcost.mh_log2_accept(torch.from_numpy(log2_u),
                               torch.tensor(beta), torch.from_numpy(l_new),
                               torch.from_numpy(l_old)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < 256

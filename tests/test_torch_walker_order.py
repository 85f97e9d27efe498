"""The parity argument of the walker kernel's design (``csrc/walker.cu``),
on the CPU.

The kernel computes widths in another order of work than the plain
version, and snapshots only the rows it marked dirty.  These tests check,
with no card, that the arguments behind both hold:

- a plain-PyTorch mirror of the kernel's tree route (lane l halves its
  words l + 32 j over j, a butterfly halves over the lanes so that lane s
  holds bit s's sum, then the 32 lanes halve over the bits) equals
  ``_width_bn``'s pinned tree bitwise;
- the popcount route, ``c * popcount(x & nz)``, equals the tree bitwise
  on uniform integer dims, bits with a zero log2 dim included;
- across the plain ``_apply_kept``, no row outside {a, b, c, e} of the
  kept walks changes, so a snapshot that copies those rows keeps the min
  state exact.

Lane sets and draws come from numpy seeds.
"""

import numpy as np
import pytest
import torch

from tnco_tpu_torch.ctree import ContractionTree
from tnco_tpu_torch.kernels import sa_batched as sb
from tnco_tpu_torch.kernels import sa_finite_batched as sfb
from tnco_tpu_torch.kernels import sa_multiwalk as smw
from tnco_tpu_torch.kernels.sa_finite import SweepConfigFW
from tnco_tpu_torch.kernels.sa_fullsweep import _width_bn
from tnco_tpu_torch.kernels.sa_infinite import SweepConfig
from tnco_tpu_torch.ops import bitops, costs
from tnco_tpu_torch.testing.networks import lattice_2d
from tnco_tpu_torch.utils.tn import get_random_contraction_path

LANES = 32
MAX_WORDS = 128     # the kernel pads W to 4 words per lane


def kernel_tree_width(lanes_wn, log2d_w32):
    """The kernel's tree route (``tree_widths`` and ``lanes_then_bits``)
    on ``int32 [W, n]`` lane sets, in float32, one IEEE add at a time.
    Returns ``[n]``."""
    w, n = lanes_wn.shape
    x = torch.zeros((MAX_WORDS, n), dtype=torch.int32)
    x[:w] = lanes_wn
    ld = torch.zeros((MAX_WORDS, LANES), dtype=torch.float32)
    ld[:w] = log2d_w32
    s = torch.arange(LANES, dtype=torch.int32)
    bits = ((x[:, :, None] >> s) & 1) != 0                 # [128, n, 32]
    t = torch.where(bits, ld[:, None, :], torch.zeros(()))
    t = t.reshape(4, LANES, n, LANES)                     # [j, lane, n, s]
    u = (t[0] + t[2]) + (t[1] + t[3])                     # [lane, n, s]
    lane = torch.arange(LANES)
    h = LANES // 2
    while h >= 1:                                         # the butterfly
        upper = ((lane & h) != 0)[:, None, None]
        keep = torch.where(upper, u[:, :, h:2 * h], u[:, :, :h])
        send = torch.where(upper, u[:, :, :h], u[:, :, h:2 * h])
        u = keep + send[lane ^ h]
        h //= 2
    v = u[:, :, 0]                                        # lane s: bit s
    h = LANES // 2
    while h >= 1:                                         # shuffle-down
        v = v[:h] + v[h:2 * h]
        h //= 2
    return v[0]


def popcount_width(lanes_wn, log2d_w32, c):
    """The kernel's popcount route: ``c * popcount(x & nz)``."""
    nz = torch.zeros(log2d_w32.shape[0], dtype=torch.int64)
    for s in range(LANES):
        nz |= (log2d_w32[:, s] != 0).to(torch.int64) << s
    masked = lanes_wn & nz.to(torch.int32)[:, None]
    cnt = bitops.popcount32(masked).sum(dim=0, dtype=torch.int32)
    return cnt.to(torch.float32) * torch.tensor(c, dtype=torch.float32)


def _lanes(rng, w, n, density):
    bits = rng.random((w, n, LANES)) < density
    words = (bits.astype(np.uint64) << np.arange(LANES, dtype=np.uint64))
    return torch.from_numpy(words.sum(axis=2).astype(np.uint32)
                            .view(np.int32))


@pytest.mark.parametrize('w', [1, 3, 64, 124])
@pytest.mark.parametrize('density', [0.05, 0.5, 0.95])
def test_kernel_tree_order_equals_width_bn(random_seed, w, density):
    rng = np.random.default_rng(random_seed)
    dims = rng.integers(2, 6, w * LANES)                  # mixed dims 2-5
    n_real = int(rng.integers(max(1, w * LANES - 31), w * LANES + 1))
    log2d = bitops.pad_log2_dims(np.log2(dims[:n_real]), w).reshape(w, LANES)
    assert len(torch.unique(log2d[log2d != 0])) > 1
    lanes = _lanes(rng, w, 300, density)
    want = _width_bn(lanes, log2d, None, torch.float32)
    got = kernel_tree_width(lanes, log2d)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.numpy().view(np.uint32))


@pytest.mark.parametrize('c', [1, 2])
@pytest.mark.parametrize('w', [1, 3, 64, 124])
def test_popcount_route_equals_tree(random_seed, c, w):
    """Uniform integer log2 dims c, with some entries 0 (dim-1 indices
    and the padding past the last index) whose bits are set too."""
    rng = np.random.default_rng(random_seed)
    n_real = int(rng.integers(max(1, w * LANES - 40), w * LANES + 1))
    log2 = np.full(n_real, float(c))
    log2[rng.random(n_real) < 0.1] = 0.0                 # dim-1 indices
    log2d = bitops.pad_log2_dims(log2, w).reshape(w, LANES)
    assert (log2d == 0).any()
    lanes = _lanes(rng, w, 300, 0.5)
    bits = ((lanes[:, :, None] >> torch.arange(LANES, dtype=torch.int32))
            & 1) != 0                                     # [W, n, 32]
    assert (bits & (log2d == 0)[:, None, :]).any()       # such bits are set
    tree = _width_bn(lanes, log2d, None, torch.float32)
    got = popcount_width(lanes, log2d, c)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  tree.numpy().view(np.uint32))
    np.testing.assert_array_equal(
        kernel_tree_width(lanes, log2d).numpy().view(np.uint32),
        tree.numpy().view(np.uint32))


def _state(fw, seed, b=3):
    """A plain-version working state on a mixed-dims 6x6 lattice."""
    rng = np.random.default_rng(seed)
    ts, out, dims = lattice_2d(6, 6)
    dims = {x: int(rng.integers(2, 6)) for x in sorted(dims)}
    trees = [ContractionTree(get_random_contraction_path(ts, out,
                                                         seed=seed + r),
                             ts, dims, output_inds=out) for r in range(b)]
    t = trees[0]
    w = t.inds_array.shape[1]
    log2d = bitops.pad_log2_dims(t.log2_dims_array, w)
    if fw:
        batch = sfb.init_batch_fw(trees, list(range(b)), 6.0, log2d.numpy(),
                                  device='cpu')
        st = smw.padded_state(batch.c0, batch.c1, batch.par, batch.inds,
                              batch.lcc, batch.width)
        st['slices'] = batch.slices
        cfg = SweepConfigFW(n_leaves=t.n_leaves, n_lanes=w,
                            prob_kind='base')
    else:
        batch = sb.init_batch(trees, list(range(b)), log2d.numpy(),
                              device='cpu')
        st = smw.padded_state(batch.c0, batch.c1, batch.par, batch.inds,
                              batch.lcc)
        cfg = SweepConfig(n_leaves=t.n_leaves, n_lanes=w, prob_kind='base')
    return st, cfg, log2d.reshape(w, LANES), len(t)


@pytest.mark.parametrize('fw', [False, True], ids=['im', 'fw'])
@pytest.mark.parametrize('p', [1, 8, 128])
def test_apply_touches_only_a_b_c_e(random_seed, fw, p):
    """Over several iterations of the plain version (prob_kind 'base', so
    every walk with an uncle is accepted and many are kept), every row
    that ``_apply_kept`` changes is an a, b, c or e of a kept walk."""
    st, cfg, log2d_w32, n = _state(fw, random_seed % 1000)
    b = st['c0'].shape[1]
    rng = np.random.default_rng(random_seed)
    pos = torch.full((b, p), -1, dtype=torch.int32)
    n_kept = 0
    for _ in range(6):
        leaf = torch.from_numpy(rng.integers(0, cfg.n_leaves, (b, p))
                                .astype(np.int32))
        rand_bit = torch.from_numpy(rng.integers(0, 2, (b, p)) > 0)
        ev = smw._propose(st, pos, leaf, rand_bit, cfg, n)
        sl = st['slices'][:, :, None] if fw else 0
        ev['ln_b'] = sb._width_b((ev['inds_d'] | ev['inds_c']) | sl,
                                 log2d_w32)
        ev['ln_a'] = sb._width_b((ev['new_inds_b'] | ev['inds_e']) | sl,
                                 log2d_w32)
        if fw:
            ev['new_width_b'] = sb._width_b(ev['new_inds_b'], log2d_w32)
        lt = costs.log2_total_from_lcc(st['lcc'][:n], cfg.n_leaves)
        l_new = costs.new_total_log2(lt[:, None], ev['l_a'], ev['l_b'],
                                     ev['ln_a'], ev['ln_b'])
        accept = smw._accept(cfg, None, None, l_new, lt, ev)
        keep = smw._claim_disjoint(accept, ev)
        before = {k: v.clone() for k, v in st.items()}
        smw._apply_kept(st, keep, ev, n)
        allowed = torch.zeros((n, b), dtype=torch.bool)
        replica = torch.arange(b)[:, None].expand(b, p)
        for k in ('a', 'b', 'c', 'e'):
            allowed[ev[k][keep].long(), replica[keep]] = True
        changed = torch.zeros((n, b), dtype=torch.bool)
        for k in ('c0', 'c1', 'par', 'inds', 'width'):
            if k not in st:
                continue
            diff = st[k][:n] != before[k][:n]
            changed |= diff.reshape(n, -1, b).any(dim=1)
        assert not (changed & ~allowed).any()
        n_kept += int(keep.sum())
        pos = ev['a']
    assert n_kept > 0


def test_hyper_chain_network_shape():
    """The card checks' network above the kernel's shared-memory topology
    limit: 7001 tensors on 3-way hyper-indices, N = 14001 nodes on
    W = 110 words, which both walker forms admit; every index is shared
    by three tensors, and a random path gives a valid tree."""
    from tnco_tpu_torch.kernels import walker as tw
    from tnco_tpu_torch.testing.networks import hyper_chain_tn

    ts, out, dims = hyper_chain_tn(7001)
    counts = {}
    for xs in ts:
        for x in xs:
            counts[x] = counts.get(x, 0) + 1
    assert set(counts.values()) == {3} and len(dims) == 3500
    tree = ContractionTree(get_random_contraction_path(ts, out, seed=0), ts,
                           dims, output_inds=out)
    assert tree.is_valid()
    n, w = len(tree), tree.inds_array.shape[1]
    assert (n, w) == (14001, 110)
    assert tw.walker_supported(n, tree.n_leaves, w)
    assert tw.walker_supported_fw(n, tree.n_leaves, w)

"""The walk engines' sequential claim (``kernels/claim.py``, its kernel
``csrc/claim.cu``): the wrapper against its plain version, a numpy model
of the kernel's algorithm (the kept-id list and the warp's vote) against
the plain version, the wrapper's checks, and on the card (``cuda``) the
kernel bitwise against the plain version and a 'walks' FW chunk with the
kernel against the same chunk with the plain claim patched in.

No JAX here: the plain version is the yardstick (its parity with the JAX
scan is held in ``test_torch_walks.py`` and ``test_torch_walker_order.py``).
"""

import numpy as np
import pytest
import torch

from tnco_tpu_torch.kernels import claim as kc
from tnco_tpu_torch.kernels import launch_counts, reset_launch_counts
from tnco_tpu_torch.kernels import sa_multiwalk as smw
from tnco_tpu_torch.kernels import sa_walks as swk

NODES = ('a', 'b', 'c', 'd', 'e')
NULL = -1


def make_case(seed, b, p, n, frac_null=0.1, frac_accept=0.5, dup=0.0):
    """``(accept, ev)`` as numpy: ids in ``[0, n)`` with ``frac_null`` of
    each plane NULL (on accepted and rejected walks alike) and ``dup`` of
    the walks repeating their first id in another plane."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n, size=(5, b, p)).astype(np.int32)
    ids[rng.random((5, b, p)) < frac_null] = NULL
    rep = rng.random((b, p)) < dup
    plane = rng.integers(1, 5, size=(b, p))
    for k in range(1, 5):
        sel = rep & (plane == k)
        ids[k][sel] = ids[0][sel]
    accept = rng.random((b, p)) < frac_accept
    return accept, dict(zip(NODES, ids))


def as_torch(accept, ev, device='cpu'):
    return (torch.from_numpy(accept).to(device),
            {k: torch.from_numpy(v).to(device) for k, v in ev.items()})


def kernel_model(accept, ev):
    """The kernel's algorithm in numpy, lane by lane: one warp a replica
    keeps its kept ids in a list; a step's 32 lanes each compare the
    walk's five ids against every 32nd entry and vote; a kept walk's ids
    are appended by lanes 0-4; lane ``i % 32`` holds walk ``i``'s bit
    until its 32-walk group is stored."""
    ids = np.stack([ev[k] for k in NODES])
    b, p = accept.shape
    keep = np.zeros((b, p), dtype=bool)
    for r in range(b):
        kept = np.empty(5 * p, dtype=np.int32)
        n_kept = 0
        mine = np.zeros(32, dtype=bool)
        for i in range(p):
            x = ids[:, r, i]
            kp = bool(accept[r, i])
            if kp:
                hit = [np.isin(kept[lane:n_kept:32], x).any()
                       for lane in range(32)]
                kp = not any(hit)
                if kp:
                    kept[n_kept:n_kept + 5] = x
                    n_kept += 5
            mine[i % 32] = kp
            if i % 32 == 31 or i == p - 1:
                base = i - i % 32
                for lane in range(i - base + 1):
                    keep[r, base + lane] = mine[lane]
    return keep


def disjoint(keep, ev):
    """Whether the kept walks of every replica share no id."""
    ids = np.stack([ev[k] for k in NODES])
    for r in range(keep.shape[0]):
        got = ids[:, r, keep[r]].T.tolist()
        seen = set()
        for walk in got:
            if seen & set(walk):
                return False
            seen |= set(walk)
    return True


# (frac_null, frac_accept, dup, n as a multiple of P): NULLs and dense
# conflicts, sparse conflicts, repeated ids within a walk, all accepted,
# none accepted.
REGIMES = {'nulls': (0.1, 0.5, 0.0, 1), 'sparse': (0.02, 0.7, 0.0, 20),
           'repeats': (0.1, 0.6, 0.5, 3), 'all': (0.05, 1.0, 0.1, 5),
           'none': (0.1, 0.0, 0.0, 2)}
WALKS = (1, 7, 8, 32, 128, 130)


@pytest.mark.parametrize('regime', sorted(REGIMES))
@pytest.mark.parametrize('p', WALKS)
def test_kernel_model_equals_the_plain_claim(p, regime):
    frac_null, frac_accept, dup, mult = REGIMES[regime]
    b = 6 if p >= 128 else 12
    accept, ev = make_case(1000 * p + len(regime), b, p, mult * p + 1,
                           frac_null, frac_accept, dup)
    want = smw._claim_disjoint(*as_torch(accept, ev)).numpy()
    np.testing.assert_array_equal(kernel_model(accept, ev), want)
    assert disjoint(want, ev)
    if regime == 'none':
        assert not want.any()
    if regime == 'all':
        assert want[:, 0].all()


def test_null_counts_as_a_node():
    """Two accepted walks that share only NULL: the second is blocked,
    as the plain conflict matrix has it (NULL == NULL)."""
    ev = {k: np.array([[10 + i, 20 + i]], dtype=np.int32)
          for i, k in enumerate(NODES)}
    ev['e'][0] = NULL
    accept = np.ones((1, 2), dtype=bool)
    want = smw._claim_disjoint(*as_torch(accept, ev)).numpy()
    np.testing.assert_array_equal(want, [[True, False]])
    np.testing.assert_array_equal(kernel_model(accept, ev), want)


def test_cpu_takes_the_plain_version_and_counts_no_launch():
    reset_launch_counts()
    accept, ev = make_case(3, 8, 32, 40)
    acc_t, ev_t = as_torch(accept, ev)
    want = kc.claim_disjoint_plain(acc_t, ev_t)
    for fn in (kc.claim_disjoint, smw._claim_disjoint,
               swk._claim_sequential):
        assert torch.equal(fn(acc_t, ev_t), want)
    # Strided inputs (the multi-walk engine's [P, B] views) give the same.
    t = {k: v.T.contiguous().T for k, v in ev_t.items()}
    assert torch.equal(kc.claim_disjoint(acc_t.T.contiguous().T, t), want)
    assert launch_counts()['claim_disjoint'] == 0


def _bad_inputs():
    acc = torch.zeros((2, 3), dtype=torch.bool)
    ids = {k: torch.zeros((2, 3), dtype=torch.int32) for k in NODES}
    yield 'int64 ids', acc, {**ids, 'c': ids['c'].long()}
    yield 'int accept', acc.int(), ids
    yield '1-D accept', acc[0], ids
    yield 'shape', acc, {**ids, 'd': torch.zeros((2, 4), dtype=torch.int32)}
    yield 'device', acc, {**ids, 'e': ids['e'].to('meta')}
    yield 'unsupported device', acc.to('meta'), {
        k: v.to('meta') for k, v in ids.items()}


@pytest.mark.parametrize('case', list(_bad_inputs()), ids=lambda c: c[0])
def test_wrong_dtype_shape_or_device_raises(case):
    _, accept, ev = case
    with pytest.raises(ValueError):
        kc.claim_disjoint(accept, ev)


# ------------------------------------------------------------- the card ---


def _card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the CUDA kernels have no CPU '
                    'mode); run python -m pytest -m cuda '
                    'tests/test_torch_claim.py on the card')


@pytest.mark.cuda
@pytest.mark.parametrize('b,p,mult', [(2048, 128, 26), (64, 32, 1),
                                      (16, 8, 2), (40, 130, 3), (4, 1, 1)])
def test_kernel_is_bitwise_against_the_plain_version(b, p, mult):
    _card()
    for seed, (frac_null, frac_accept, dup) in enumerate(
            ((0.1, 0.5, 0.0), (0.05, 1.0, 0.3), (0.3, 0.8, 0.0))):
        accept, ev = make_case(seed, b, p, mult * p + 1, frac_null,
                               frac_accept, dup)
        acc_t, ev_t = as_torch(accept, ev, 'cuda')
        reset_launch_counts()
        got = kc.claim_disjoint(acc_t, ev_t)
        assert launch_counts()['claim_disjoint'] == 1
        want = kc.claim_disjoint_plain(acc_t, ev_t)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (b, p, seed)
        # The same planes as transposed views.
        t = {k: v.T.contiguous().T for k, v in ev_t.items()}
        assert torch.equal(kc.claim_disjoint(acc_t.T.contiguous().T, t),
                           want)


@pytest.mark.cuda
def test_walks_fw_chunk_is_bitwise_with_the_plain_claim(monkeypatch):
    _card()
    from test_torch_spans import FW, tiny_runner

    from portbench import runners
    betas = np.linspace(1, 8, 32).astype(np.float32)
    got, config, traffic = tiny_runner(FW, device='cuda')
    reset_launch_counts()
    runners.run_chunk(got, config, traffic, betas)
    assert launch_counts()['claim_disjoint'] == 32
    monkeypatch.setattr(swk, '_claim_sequential', kc.claim_disjoint_plain)
    want, _, _ = tiny_runner(FW, device='cuda')
    runners.run_chunk(want, config, traffic, betas)
    assert launch_counts()['claim_disjoint'] == 32
    for name, x in vars(got.states).items():
        y = getattr(want.states, name)
        if x.dtype.is_floating_point:
            assert torch.equal(x.view(torch.int32 if x.element_size() == 4
                                      else torch.int64),
                               y.view(torch.int32 if y.element_size() == 4
                                      else torch.int64)), name
        else:
            assert torch.equal(x, y), name
    assert torch.equal(got._mw_pos, want._mw_pos)

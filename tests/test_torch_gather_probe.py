"""P1, the row-read probe: the port's plain route == the JAX probe.

The JAX side is ``benchmarks.pallas_gather_probe.probe(..., interpret=
True)``, both Pallas bodies in interpret mode on the CPU.  The inputs come
from a numpy seed, with repeated ids (within a round and across rounds,
and rounds whose ids come from 4 distinct rows), so the ordered writes'
last-i-wins rule and the reads of rows written in earlier rounds are both
exercised.  A test-local model holds the two facts the loop kernel rests
on (columns are independent; a round's writes commute) against the JAX
result, and the loop's route is a tested function of (N, P).  The CUDA
kernels run only on the card (``-m cuda``; skipped elsewhere): every
route at the cases of ``tnco_tpu_torch.testing.kernel_cases``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from benchmarks import pallas_gather_probe as jprobe
from tnco_tpu_torch.benchmarks import gather_probe as gp
from tnco_tpu_torch.kernels import launch_counts
from tnco_tpu_torch.testing import kernel_cases as kc


def _inputs(r, n, p, rounds, repeats):
    """``repeats``: True (repeats within and across rounds), False, or
    'heavy' (every round's ids from 4 distinct rows)."""
    state = r.integers(-2**31, 2**31, (n, gp.COLS)).astype(np.int32)
    ids = kc.probe_ids(r, n, p, rounds, repeats == 'heavy')
    if repeats is True and p > 1:
        ids[:, p // 2:] = ids[:, :p - p // 2][:, ::-1]   # within a round
        ids[1:, 0] = ids[:-1, -1]                        # across rounds
    return state, ids


@pytest.mark.parametrize('impl', gp.IMPLS)
@pytest.mark.parametrize('n,p,rounds,repeats', [
    (40, 8, 3, True), (17, 5, 4, True), (40, 8, 3, False), (9, 1, 1, False),
    (3, 6, 5, True), (40, 128, 4, 'heavy'), (33, 7, 5, 'heavy'),
    (41, 129, 3, True), (50, 33, 2, False)])
def test_probe_plain_matches_jax(random_seed, impl, n, p, rounds, repeats):
    r = np.random.default_rng(random_seed)
    state, ids = _inputs(r, n, p, rounds, repeats)
    ts = torch.from_numpy(state.copy())
    got = gp.probe(ts, torch.from_numpy(ids), impl)
    want = jprobe.probe(jnp.asarray(state), jnp.asarray(ids), impl,
                        interpret=True)
    assert got.dtype == torch.int32 and got.shape == (p, gp.COLS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(ts.numpy(), state)         # the input unchanged


def _loop_model(state, ids, order, col_blocks, seed):
    """The loop as the smem kernel computes it: the columns in
    ``col_blocks`` independent blocks, and each round's writes as one
    unordered ``index_put_`` of the rows in ``order`` ('reverse' or
    'random'), not in the order of i."""
    r = np.random.default_rng(seed)
    n, p = state.shape[0], ids.shape[1]
    safe = ids.clamp(0, n - 1).long()
    outs = []
    for cols in torch.arange(gp.COLS).chunk(col_blocks):
        work = state[:, cols].clone()
        for row in safe:
            scratch = work[row]
            perm = torch.arange(p - 1, -1, -1) if order == 'reverse' else \
                torch.from_numpy(r.permutation(p))
            work.index_put_((row[perm],), scratch[perm] + 1)
        outs.append(scratch)
    return torch.cat(outs, 1)


@pytest.mark.parametrize('order', ['reverse', 'random'])
@pytest.mark.parametrize('col_blocks', [1, 4, 128])
@pytest.mark.parametrize('repeats', [True, 'heavy'])
def test_loop_writes_commute_and_columns_split(random_seed, order,
                                               col_blocks, repeats):
    r = np.random.default_rng(random_seed)
    state, ids = _inputs(r, 40, 16, 6, repeats)
    want = jprobe.probe(jnp.asarray(state), jnp.asarray(ids), 'loop',
                        interpret=True)
    got = _loop_model(torch.from_numpy(state), torch.from_numpy(ids), order,
                      col_blocks, random_seed)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_loop_route_thresholds():
    """The smem route holds one column of N rows and two stage buffers of
    ids in a block's shared memory; the global route takes larger N."""
    p = 128                                   # 16 rounds a stage
    ids_bytes = 4 * 2 * gp.STAGE_WORDS
    n_max = (gp.SMEM_BYTES - ids_bytes) // 4
    assert n_max == 54016
    assert gp.loop_route(3328, p) == 'smem'
    assert gp.loop_route(n_max, p) == 'smem'
    assert gp.loop_route(n_max + 1, p) == 'global'
    assert gp.loop_route(60000, p) == 'global'
    # P = 454: 4 rounds a stage (1816 words), so a column of more rows.
    assert gp.loop_route(54480, gp.MAX_LOOP_P) == 'smem'
    assert gp.loop_route(54481, gp.MAX_LOOP_P) == 'global'


@pytest.mark.parametrize('p,threads', [
    (1, 32), (31, 32), (32, 32), (33, 64), (128, 128), (129, 160),
    (454, 480)])
def test_loop_threads(p, threads):
    """One thread a pair of the round, in whole warps, within a block."""
    assert gp.loop_threads(p) == threads
    assert p <= threads < p + 32 and threads <= 1024


@pytest.mark.parametrize('p,rounds', [
    (1, 2048), (7, 292), (128, 16), (129, 15), (300, 6),
    (gp.MAX_LOOP_P, 4)])
def test_loop_stage_rounds(p, rounds):
    """A stage buffer holds the most whole rounds of ids that fit
    STAGE_WORDS words, and at least one."""
    assert gp.loop_stage_rounds(p) == rounds
    assert rounds * p <= gp.STAGE_WORDS < (rounds + 1) * p


@pytest.mark.parametrize('case', kc.PROBE_CASES, ids=lambda c: c.name)
def test_probe_cases_take_their_route(case):
    """Each card case runs the global route and, where a column of its N
    rows and the stage buffers fit a block, the smem route too."""
    routes = kc.loop_routes(case.n, case.p)
    assert routes[-1] == 'global'
    words = case.n + 2 * gp.loop_stage_rounds(case.p) * case.p
    assert ('smem' in routes) == (4 * words <= gp.SMEM_BYTES)
    assert routes[0] == gp.loop_route(case.n, case.p)


def test_probe_take_wraps_in_int32():
    """The sum wraps modulo 2**32 as the JAX int32 sum does (torch's
    default integer sum would widen to int64)."""
    state = np.full((2, gp.COLS), 2**31 - 1, dtype=np.int32)
    ids = np.zeros((3, 4), dtype=np.int32)
    got = gp.probe(torch.from_numpy(state), torch.from_numpy(ids), 'take')
    want = jprobe.probe(jnp.asarray(state), jnp.asarray(ids), 'take',
                        interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0, 0] == np.int32(2**31 - 3)


@pytest.mark.parametrize('case', ['impl', 'cols', 'ids_dtype', 'no_rounds',
                                  'wide_p'])
def test_probe_rejects_bad_inputs(case):
    state = torch.zeros((4, gp.COLS), dtype=torch.int32)
    ids = torch.zeros((2, 3), dtype=torch.int32)
    impl = 'loop'
    if case == 'impl':
        impl = 'gather'
    elif case == 'cols':
        state = torch.zeros((4, 64), dtype=torch.int32)
    elif case == 'ids_dtype':
        ids = ids.long()
    elif case == 'no_rounds':
        ids = torch.zeros((0, 3), dtype=torch.int32)
    elif case == 'wide_p':
        ids = torch.zeros((1, gp.MAX_LOOP_P + 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        gp.probe(state, ids, impl)


def test_probe_main_on_cpu(capsys):
    res = gp.main(['6', '2', '--device', 'cpu'])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == 'cpu'
    for line, impl in zip(lines[1:], gp.IMPLS):
        assert line.startswith(f'{impl}: ') and line.endswith(' ns/row')
    assert res['loop']['row_ops'] == 2 * 6 * 2
    assert res['take']['row_ops'] == 6 * 2
    counts = launch_counts()
    assert counts['probe_loop'] == counts['probe_take'] == 0  # plain route


@pytest.mark.cuda
@pytest.mark.parametrize('case', kc.PROBE_CASES, ids=lambda c: c.name)
def test_probe_kernels_match_plain_on_card(random_seed, case):
    """Every route of the loop kernel and both impls through the
    wrapper, bitwise against the plain version, the caller's state
    unchanged."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the CUDA kernels have no CPU '
                    'mode); run python3 chip_smoke.py on the card')
    assert kc.check_probe(case, torch.device('cuda'), seed=random_seed) == []

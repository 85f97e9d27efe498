"""P1, the row-read probe: the port's plain route == the JAX probe.

The JAX side is ``benchmarks.pallas_gather_probe.probe(..., interpret=
True)``, both Pallas bodies in interpret mode on the CPU.  The inputs come
from a numpy seed, with repeated ids (within a round and across rounds),
so the ordered writes' last-i-wins rule and the reads of rows written in
earlier rounds are both exercised.  The CUDA kernels run only on the card
(``-m cuda``; skipped elsewhere).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from benchmarks import pallas_gather_probe as jprobe
from tnco_tpu_torch.benchmarks import gather_probe as gp


def _inputs(r, n, p, rounds, repeats):
    state = r.integers(-2**31, 2**31, (n, gp.COLS)).astype(np.int32)
    ids = r.integers(0, n, (rounds, p)).astype(np.int32)
    if repeats and p > 1:
        ids[:, p // 2:] = ids[:, :p - p // 2][:, ::-1]   # within a round
        ids[1:, 0] = ids[:-1, -1]                        # across rounds
    return state, ids


@pytest.mark.parametrize('impl', gp.IMPLS)
@pytest.mark.parametrize('n,p,rounds,repeats', [
    (40, 8, 3, True), (17, 5, 4, True), (40, 8, 3, False), (9, 1, 1, False),
    (3, 6, 5, True)])
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
    assert gp.loop_launches == gp.take_launches == 0  # plain route


@pytest.mark.cuda
@pytest.mark.parametrize('n,p,rounds', [(3328, 128, 256), (3328, 1, 1),
                                        (40, 8, 3)])
def test_probe_kernels_match_plain_on_card(random_seed, n, p, rounds):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the CUDA kernels have no CPU '
                    'mode); run python3 chip_smoke.py on the card')
    r = np.random.default_rng(random_seed)
    state, ids = _inputs(r, n, p, rounds, True)
    ts = torch.from_numpy(state).cuda()
    ti = torch.from_numpy(ids).cuda()
    for impl in gp.IMPLS:
        assert torch.equal(gp.probe(ts, ti, impl),
                           gp.probe_plain(ts, ti, impl))
        assert np.array_equal(ts.cpu().numpy(), state)

"""Acceptance-decision parity: log2-domain floats vs exact arithmetic
(the port's copy of ``tnco_tpu/testing/accept_parity.py``).

The reference evaluates every Metropolis acceptance in the *linear*
domain with up to 1024-bit floats (include/tnco/optimize/infinite_memory/
optimizer.hpp:150-162; prob/mh.hpp:45-59): ``u <= (1 + delta/old)^-beta``
with ``delta`` computed exactly.  The rebuild accepts in the f32/f64
*log2* domain (``ops/costs.new_total_log2`` / ``delta_log2_local``),
whose rounding can flip a knife-edge decision.  This module measures how
often: it replays identical proposal streams (same states, same ``u``
draws, same betas) through

- the engine's float rule (numpy mirror of the exact op order of
  ``costs.new_total_log2`` and ``costs.delta_log2_local``, in f32 / f64),
- an exact oracle (Python-bigint linear costs; ``Decimal`` logs at 60
  significant digits — ~200 bits, strictly tighter than the reference's
  1024-bit mantissa for the comparison margin involved),

and reports the flip rate.  The mirrors and the oracle are the JAX
package's, operation for operation; the states come from the port's
lockstep engine (:func:`sample_states`), or are given, so that the
states the JAX package sampled give its numbers exactly.
"""

from decimal import Decimal, getcontext
from fractions import Fraction

import numpy as np

__all__ = ['sample_states', 'measure_flip_rate']

NULL = -1


def _pairwise_sum(terms: np.ndarray) -> np.ndarray:
    """Order-pinned halving-tree sum over axis 0 (mirror of
    ``ops/costs.pairwise_sum`` / ``ops/bitops.pairwise_sum_last``)."""
    n = terms.shape[0]
    if n == 0:
        return np.zeros(terms.shape[1:], terms.dtype)
    p = 1 << (n - 1).bit_length() if n > 1 else 1
    if p != n:
        terms = np.concatenate(
            [terms, np.zeros((p - n,) + terms.shape[1:], terms.dtype)],
            axis=0)
    while terms.shape[0] > 1:
        h = terms.shape[0] // 2
        terms = terms[:h] + terms[h:]
    return terms[0]


class _FloatRule:
    """Numpy mirror of the device log2-domain acceptance at one dtype."""

    def __init__(self, log2d: np.ndarray, dtype):
        self.dtype = np.dtype(dtype)
        # Padded per-bit log2 dims in the engine's (w*32+s) order.
        self.log2d = log2d.astype(self.dtype)
        self.n_bits = log2d.shape[0]

    def width(self, bits: int):
        """Pinned-order width of a Python-int bitset (bitops.width)."""
        mask = np.zeros(self.n_bits, dtype=bool)
        i = 0
        while bits:
            if bits & 1:
                mask[i] = True
            bits >>= 1
            i += 1
        terms = np.where(mask, self.log2d, self.dtype.type(0))
        return _pairwise_sum(terms)

    def log2_total(self, lcc_internal: np.ndarray):
        """costs.log2_total_from_lcc on the internal-node slice."""
        m = lcc_internal.max()
        s = _pairwise_sum(np.exp2(lcc_internal - m))
        return (m + np.log2(s)).astype(self.dtype)

    def l_new_total(self, lt, l_a, l_b, ln_a, ln_b):
        """costs.new_total_log2 (max-shifted linear evaluation)."""
        one = self.dtype.type
        m = np.maximum(lt, np.maximum(ln_a, ln_b))
        s = (np.exp2(lt - m) - np.exp2(l_a - m) - np.exp2(l_b - m) +
             np.exp2(ln_a - m) + np.exp2(ln_b - m))
        floor = one(2.0) ** one(-60)
        return (m + np.log2(np.maximum(s, floor))).astype(self.dtype)

    def delta_local(self, lt, l_a, l_b, ln_a, ln_b):
        """costs.delta_log2_local (log1p form)."""
        one = self.dtype.type
        m = max(max(l_a, l_b), max(ln_a, ln_b))
        d = (np.exp2(one(ln_a - m)) + np.exp2(one(ln_b - m)) -
             np.exp2(one(l_a - m)) - np.exp2(one(l_b - m)))
        x = d * np.exp2(one(m - lt))
        x = np.maximum(x, one(2.0) ** one(-60) - one(1.0))
        return (np.log1p(x) *
                one(1.4426950408889634)).astype(self.dtype)


def _exact_cost(bits: int, dims: np.ndarray) -> int:
    c = 1
    i = 0
    while bits:
        if bits & 1:
            c *= int(dims[i])
        bits >>= 1
        i += 1
    return c


def _lanes_to_int(lanes: np.ndarray) -> int:
    out = 0
    for w in range(lanes.shape[0] - 1, -1, -1):
        out = (out << 32) | int(lanes[w])
    return out


def sample_states(ctree, seeds, betas_warmup, n_checkpoints: int = 4, *,
                  device=None):
    """Realistic mid-anneal states: run the port's lockstep engine
    (:func:`~tnco_tpu_torch.kernels.sa_batched.run_sweeps_batched`, its
    draws from a generator seeded with the seeds) on ``device`` (None
    means the card) and snapshot the batch at ``n_checkpoints`` points
    along the schedule.

    Returns a list of host states ``(c0, c1, par, inds_int[N], beta)``.
    """
    import torch

    from tnco_tpu_torch.device import resolve_device
    from tnco_tpu_torch.kernels import sa_batched as sb
    from tnco_tpu_torch.kernels import sa_infinite as sa

    dev = resolve_device(device)
    n_lanes = ctree.inds_array.shape[1]
    cfg = sa.SweepConfig(n_leaves=ctree.n_leaves, n_lanes=n_lanes)
    log2d = _padded_log2d(ctree)
    batch = sb.init_batch([ctree] * len(seeds), list(seeds),
                          log2d.astype(np.float32), device=dev)
    log2d_w32 = torch.from_numpy(log2d.astype(np.float32)).to(dev).reshape(
        n_lanes, 32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(np.random.SeedSequence(list(seeds)).generate_state(
        1)[0]))

    betas = np.asarray(betas_warmup, dtype=np.float32)
    chunks = np.array_split(betas, n_checkpoints)
    states = []
    for chunk in chunks:
        batch, _ = sb.run_sweeps_batched(batch, chunk, log2d_w32, cfg,
                                         generator=gen)
        c0 = batch.c0.cpu().numpy()
        c1 = batch.c1.cpu().numpy()
        par = batch.par.cpu().numpy()
        inds = batch.inds.cpu().numpy().view(np.uint32)
        for r in range(c0.shape[1]):
            ints = [_lanes_to_int(inds[i, :, r])
                    for i in range(c0.shape[0])]
            states.append((c0[:, r].copy(), c1[:, r].copy(),
                           par[:, r].copy(), ints, float(chunk[-1])))
    return states


def _padded_log2d(ctree) -> np.ndarray:
    """The per-bit log2 dims padded to ``W * 32``, rounded to float32 and
    held as float64 (as the JAX package's mirror takes its padded
    table)."""
    out = np.zeros(ctree.inds_array.shape[1] * 32, dtype=np.float32)
    dims = np.asarray(ctree.log2_dims_array, dtype=np.float64)
    out[:dims.shape[0]] = dims
    return out.astype(np.float64)


def measure_flip_rate(ctree, *, n_states: int = 8, n_u: int = 4,
                      betas_warmup=None, seed: int = 0,
                      rules=('total', 'local'),
                      dtypes=(np.float32, np.float64), states=None,
                      device=None) -> dict:
    """Flip rate of the float accept vs the exact accept.

    For every state, every internal non-root node B (with the kernel's
    D/E shared-index selection rule) and ``n_u`` fresh uniform draws,
    decide acceptance with the float rule and with exact arithmetic;
    count disagreements.  Returns ``{(rule, dtype_name): {'proposals': n,
    'flips': k, 'rate': k/n, 'expected_flips': p, 'expected_rate':
    p/decisions, 'decisions': d}}`` plus ``'proposals'`` overall.

    Sampled flips are a weak instrument (a flip needs ``u`` to land in
    the sliver between the float and exact acceptance thresholds), so
    each entry also carries the EXACT expected flip probability: per
    decision, ``|min(1, 2^(-beta*delta_float)) -
    min(1, 2^(-beta*delta_exact))|`` evaluated in 60-digit Decimal
    (the float delta is a binary rational, hence exactly representable)
    — the measure of the ``u``-interval where the two rules disagree.
    ``expected_rate`` is therefore the borderline-flip probability per
    proposal, with no sampling noise.

    ``states``: the states to replay (as :func:`sample_states` returns
    them); None samples ``n_states`` replicas on ``device`` (None means
    the card).
    """
    getcontext().prec = 60
    rng = np.random.default_rng(seed)
    if betas_warmup is None:
        betas_warmup = np.linspace(0.0, 60.0, 32)

    n_lanes = ctree.inds_array.shape[1]
    log2d = _padded_log2d(ctree)
    dims = np.ones(n_lanes * 32, dtype=np.int64)
    dims[:ctree.dims_array.shape[0]] = ctree.dims_array
    n_leaves = ctree.n_leaves

    if states is None:
        states = sample_states(ctree, list(range(n_states)), betas_warmup,
                               device=device)
    frules = {np.dtype(d).name: _FloatRule(log2d, d) for d in dtypes}

    counts = {(r, dn): {'proposals': 0, 'flips': 0, 'decisions': 0,
                        'expected_flips': Decimal(0)}
              for r in rules for dn in frules}
    ln2 = Decimal(2).ln()

    def p_accept(beta_dec: Decimal, delta_dec: Decimal) -> Decimal:
        """min(1, 2^(-beta*delta)) in Decimal."""
        e = -beta_dec * delta_dec
        if e >= 0:
            return Decimal(1)
        return (e * ln2).exp()

    for c0, c1, par, inds, beta in states:
        n = c0.shape[0]
        # Exact per-node linear costs + total (bigints).
        exact = [0] * n
        for i in range(n):
            if c0[i] != NULL:
                exact[i] = _exact_cost(inds[c0[i]] | inds[c1[i]], dims)
        t_exact = sum(exact)
        log2_t_exact = Decimal(t_exact).ln() / ln2

        # Float per-node lcc + totals per dtype.
        lcc = {}
        lt = {}
        for dn, fr in frules.items():
            vals = np.full(n, -np.inf, dtype=fr.dtype)
            for i in range(n):
                if c0[i] != NULL:
                    vals[i] = fr.width(inds[c0[i]] | inds[c1[i]])
            lcc[dn] = vals
            lt[dn] = fr.log2_total(vals[n_leaves:])

        for b in range(n_leaves, n):
            a = par[b]
            if a == NULL:
                continue
            c = c1[a] if c0[a] == b else c0[a]
            d0, d1 = c0[b], c1[b]
            i0 = (inds[d0] & inds[c]) != 0
            i1 = (inds[d1] & inds[c]) != 0
            if i0 and i1:
                take0 = bool(rng.integers(2))
            else:
                take0 = i0
            d, e = (d0, d1) if take0 else (d1, d0)
            hyp_a = inds[a] & inds[b] & inds[c]
            hyp_b = inds[b] & inds[d0] & inds[d1]
            new_b = (inds[d] ^ inds[c]) | hyp_a | hyp_b
            set_nb = inds[d] | inds[c]
            set_na = new_b | inds[e]

            na_exact = _exact_cost(set_na, dims)
            nb_exact = _exact_cost(set_nb, dims)
            tn_exact = t_exact - exact[a] - exact[b] + na_exact + nb_exact
            dlog2_exact = (Decimal(tn_exact).ln() / ln2) - log2_t_exact

            us = rng.uniform(size=n_u)
            log2_us_exact = [Decimal(Fraction(u).numerator) /
                             Decimal(Fraction(u).denominator)
                             for u in us]
            log2_us_exact = [x.ln() / ln2 for x in log2_us_exact]
            acc_exact = [lu <= -Decimal(beta) * dlog2_exact
                         for lu in log2_us_exact]

            for dn, fr in frules.items():
                la, lb = lcc[dn][a], lcc[dn][b]
                lna = fr.width(set_na)
                lnb = fr.width(set_nb)
                deltas = {}
                if 'total' in rules:
                    deltas['total'] = (fr.l_new_total(lt[dn], la, lb,
                                                      lna, lnb) - lt[dn])
                if 'local' in rules:
                    deltas['local'] = fr.delta_local(lt[dn], la, lb,
                                                     lna, lnb)
                beta_f = Decimal(float(fr.dtype.type(beta)))
                p_exact = p_accept(Decimal(float(beta)), dlog2_exact)
                for rule, delta in deltas.items():
                    cnt = counts[(rule, dn)]
                    cnt['decisions'] += 1
                    p_float = p_accept(beta_f, Decimal(float(delta)))
                    cnt['expected_flips'] += abs(p_float - p_exact)
                    for u, ax in zip(us, acc_exact):
                        lu = fr.dtype.type(np.log2(fr.dtype.type(u)))
                        acc_f = bool(lu <= -fr.dtype.type(beta) * delta)
                        cnt['proposals'] += 1
                        cnt['flips'] += int(acc_f != ax)

    out = {}
    total = 0
    for key, cnt in counts.items():
        rate = cnt['flips'] / max(cnt['proposals'], 1)
        ef = float(cnt['expected_flips'])
        out['%s_%s' % key] = {
            'proposals': cnt['proposals'], 'flips': cnt['flips'],
            'rate': rate, 'decisions': cnt['decisions'],
            'expected_flips': ef,
            'expected_rate': ef / max(cnt['decisions'], 1)}
        total = max(total, cnt['proposals'])
    out['proposals'] = total
    return out

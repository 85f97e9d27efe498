"""Island stall detection + kick orchestration (round-5 FW fix; the port
of ``tnco_tpu/parallel/stall.py``, with its fields and defaults).

Round 4 established that the FW flagship search is bimodal: with
whole-population exchange, ~1/3 of product-default runs collapse into
a seed-independent ~68.3 attractor within the first ~10% of the budget
and freeze (docs/QUALITY.md).  The diagnosis (round 5, from the
per-chunk curves in QUALITY_r4.jsonl): stuck runs' improvement
velocity drops to ~0.00-0.05 bits per 15 chunks after chunk ~60 while
good runs burst 0.1-0.8 throughout, and the "worst 25% <- population
best" exchange keeps recycling explorers into the attractor.

Two complementary mechanisms, both OUTSIDE the kernels (engine
bit-identity invariants untouched):

- **Islands** (``replicas.exchange_best_fw(..., islands=G)``): exchange
  intensifies within G independent groups, so a collapse must happen
  G times independently to sink the run.
- **Kick** (:class:`IslandStallKicker` + ``replicas.kick_lanes_fw``):
  when an island's best-so-far stops improving, its non-leading lanes
  restart from the island-best tree with FORCED fresh slice sets
  (breaking the keep-iff-better reslice gate that locks the
  tree+slice attractor) and fresh PRNG streams, and the island's
  exchange is suspended for a few events so the re-diversified lanes
  are not immediately overwritten.

Drive it from a chunked annealing loop::

    kicker = IslandStallKicker(runner, islands=4)
    for chunk in ...:
        runner.run(betas_chunk, ...)
        kicker.observe(chunk, elapsed_fraction)
        if chunk % exchange_every == 0:
            runner.states = exchange_best_fw(
                runner.states, islands=kicker.islands,
                active=kicker.exchange_active(chunk))
"""

from dataclasses import dataclass, field

import numpy as np

from tnco_tpu_torch.parallel.replicas import kick_lanes_fw

__all__ = ['IslandStallKicker']


@dataclass
class IslandStallKicker:
    """Per-island stall watchdog over a lane-major FW runner.

    An island is "stalled" when its best-so-far has not improved by
    ``min_delta`` bits in ``window_chunks`` observations; a stalled
    island is kicked (all lanes except its ``keep_top`` current
    leaders) at most once per ``cooldown_chunks``, and never after
    ``frac_guard`` of the budget (a late restart cannot re-anneal).
    False positives are cheap by construction: leaders and min
    snapshots survive every kick.

    Setting ``min_delta`` high (e.g. 10 bits over a 10-chunk window)
    turns the watchdog into PERIODIC re-diversification — every island
    is kicked once per cooldown regardless of progress.  That is the
    round-5 flagship product default: its 300 s A/B matched the
    stall-triggered medians with a far tighter tail (6-rep worst 63.73
    vs 65.54 — docs/QUALITY.md round-5 matrix).
    """

    runner: object
    islands: int
    window_chunks: int = 60
    min_delta: float = 0.1
    frac_guard: float = 0.85
    cooldown_chunks: int = 60
    keep_top: int = 2
    exchange_skip_chunks: int = 24
    seed: int = 0
    kicks: list = field(default_factory=list)

    def __post_init__(self):
        g = self.islands
        b = int(self.runner.states.log2_total.shape[0])
        if g < 1 or b % g:
            raise ValueError(f"islands={g} must divide replicas {b}.")
        self._bg = b // g
        self._mark = np.full(g, np.inf)
        self._last_improve = np.zeros(g, dtype=np.int64)
        self._rearm = np.zeros(g, dtype=np.int64)
        self._suspend_until = np.full(g, -1, dtype=np.int64)
        self._n_kicks = 0

    def exchange_active(self, chunk: int) -> np.ndarray:
        """bool[G]: which islands may exchange at this chunk."""
        return np.asarray(chunk >= self._suspend_until)

    def observe(self, chunk: int, frac: float,
                mins=None) -> list[int]:
        """Update per-island progress marks; kick stalled islands.

        ``mins``: optionally the already-pulled per-lane
        ``log2_min_totals()`` (chunked loops share one device pull
        per chunk between the curve, the watchdog and diagnostics).
        Returns the indices of islands kicked at this observation.
        """
        g, bg = self.islands, self._bg
        if mins is None:
            mins = np.asarray(self.runner.log2_min_totals())
        mins_g = mins.reshape(g, bg).min(axis=1)
        improved = mins_g <= self._mark - self.min_delta
        self._mark = np.where(improved, mins_g, self._mark)
        self._last_improve[improved] = chunk

        kicked = []
        if frac >= self.frac_guard:
            return kicked
        lt = None
        for gi in range(g):
            if (chunk - self._last_improve[gi] < self.window_chunks
                    or chunk < self._rearm[gi]):
                continue
            if lt is None:
                lt = self.runner.states.log2_total.cpu().numpy()
            lanes = np.arange(gi * bg, (gi + 1) * bg)
            order = lanes[np.argsort(lt[lanes], kind='stable')]
            src = int(order[0])
            victims = order[self.keep_top:]
            self._n_kicks += 1
            kick_lanes_fw(self.runner, victims, src,
                          seed=self.seed * 131071 + self._n_kicks)
            self._rearm[gi] = chunk + self.cooldown_chunks
            self._last_improve[gi] = chunk
            self._suspend_until[gi] = chunk + self.exchange_skip_chunks
            self.kicks.append({'chunk': int(chunk), 'island': int(gi),
                               'frac': float(frac),
                               'island_min': float(mins_g[gi])})
            kicked.append(gi)
        return kicked

"""The comparison that decides ``correct``.

After the window the harness reads, for a sample of replicas drawn from
the seed and the best replica, what the program reports: the best tree,
its slices (finite width), its best log2 cost, and the current tree.  The
plain reference (:mod:`portbench.reference`) judges them from the network
and the starting paths alone.  The numbers compared, each held to a limit
from the configuration file's ``"check"`` entry (a number passes when it
is at most its limit):

- ``invalid_trees``: judged replicas whose best or current tree is not a
  binary contraction tree over all tensors (or whose slices name an index
  the network lacks);
- ``over_cap_nodes``: nodes of the judged best trees wider than the cap
  after their slices (finite width only);
- ``cost_gap_log2``: the widest gap between a reported best log2 cost and
  the reference's exact one for the same tree and slices;
- ``best_over_current_log2``: the widest gap by which a reported best
  log2 cost lies above the reference's exact cost of the same replica's
  current tree (with its current slices, where those fit the cap) and,
  infinite memory, of its starting path: a best that the anneal has
  passed by and not taken up;
- ``unmoved_trees``: judged replicas whose current tree is still the tree
  its starting path built (a replica that annealed has moved).

The control puts the reference in the program's place one precision down
(:func:`portbench.reference.log2_total_lowp` in bfloat16): it reports the
log2 cost of the program's own best trees computed in bfloat16.
"""

import math

from portbench import reference

__all__ = ['judge', 'Verdict']


class Verdict:
    """``numbers``: name -> (value, limit); ``failed``: the judged
    replicas that failed a number; ``attempted``; ``best_log2``: the
    reference's exact log2 cost of the best replica's tree; ``reasons``:
    a few of the failures in words."""

    def __init__(self, numbers, attempted, failed, best_log2, reasons):
        self.numbers = numbers
        self.attempted = attempted
        self.failed = failed
        self.best_log2 = best_log2
        self.reasons = reasons

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(v <= lim for v, lim in
                                        self.numbers.values())


def judge(ref, ans, starts, best_replica, limits, max_width=None,
          control=False) -> Verdict:
    """Judges :class:`portbench.runners.Answers` ``ans``.

    ``starts[r]``: the starting path of replica ``r``; ``best_replica``:
    the replica whose exact cost is the best cost reported; ``limits``:
    name -> limit; ``max_width``: the cap (None: infinite memory);
    ``control``: judge the bfloat16 control instead of the reported
    costs."""
    fw = max_width is not None
    shapes, start_log2 = {}, {}
    invalid = over = unmoved = 0
    gap, above = 0.0, -math.inf
    failed = 0
    best_log2 = math.nan
    reasons = []
    for i, r in enumerate(ans.replicas):
        slices = reference.lanes_to_mask(ans.slices[i]) if fw else 0
        rep = ref.tree_report(*ans.best[i], slices=slices,
                              max_width=max_width)
        cur = ref.tree_report(
            *ans.current[i], max_width=max_width,
            slices=(reference.lanes_to_mask(ans.current_slices[i]) if fw
                    else 0))
        if not rep.valid or not cur.valid:
            invalid += 1
            failed += 1
            reasons.append(f'replica {r}: ' + (rep.reason or 'current: ' +
                                               cur.reason))
            continue
        over += rep.over_cap
        reported = (reference.log2_total_lowp(rep.log2_costs) if control
                    else ans.reported[i])
        g = abs(reported - rep.log2_total)
        g = math.inf if math.isnan(g) else g
        gap = max(gap, g)
        bad = rep.over_cap > 0 or g > limits['cost_gap_log2']
        start = starts[r]
        if id(start) not in shapes:
            shapes[id(start)] = reference.path_shape(start, ref.n_leaves)
            if not fw:
                start_log2[id(start)] = ref.path_report(start).log2_total
        # The best can be no worse than a tree the replica holds or held.
        passed = [cur.log2_total] if cur.over_cap == 0 else []
        if not fw:
            passed.append(start_log2[id(start)])
        if passed:
            a = reported - min(passed)
            a = math.inf if math.isnan(a) else a
            above = max(above, a)
            if a > limits['best_over_current_log2']:
                bad = True
                reasons.append(f'replica {r}: best {reported} above a '
                               f'tree it held, {min(passed)}')
        if reference.tree_shape(*ans.current[i], ref.n_leaves) == \
                shapes[id(start)]:
            unmoved += 1
            bad = True
            reasons.append(f'replica {r}: never moved')
        if r == best_replica:
            best_log2 = rep.log2_total
        failed += bad
    numbers = {'invalid_trees': (invalid, limits['invalid_trees'])}
    if fw:
        numbers['over_cap_nodes'] = (over, limits['over_cap_nodes'])
    numbers['cost_gap_log2'] = (gap, limits['cost_gap_log2'])
    numbers['best_over_current_log2'] = (
        above if above > -math.inf else 0.0,
        limits['best_over_current_log2'])
    numbers['unmoved_trees'] = (unmoved, limits['unmoved_trees'])
    return Verdict(numbers, len(ans.replicas), failed, best_log2,
                   reasons[:5])

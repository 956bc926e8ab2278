"""Host-side BiWFA recursion: breakpoint waves -> split -> stitch.

One :class:`BidirDriver` owns one ``trace_variant="bidir"`` CIGAR ticket.
It never aligns anything itself — every sub-problem is resubmitted through
the *same* :class:`~repro_torch.core.session.AlignmentSession` as an
internal ticket, so recursion children batch with live traffic, share the
engine's specialisation cache, and retire through the ordinary wave
pipeline:

1. **score pass** — one internal ``output="score"`` ticket over the whole
   batch resolves each pair's cost ``s`` (the meet solver needs the target
   to anchor its split detection, and score-only waves are the cheapest
   way to get it).
2. **recurse** — each pair becomes a segment tree.  A segment whose
   ``s * (plen + tlen)`` fits the trace budget base-cases to the packed
   backtrace (an ``output="cigar"`` child capped at its known cost);
   anything larger dispatches a breakpoint wave
   (the backend's meet variant, on ``kernel`` the CUDA meet kernel, else
   :func:`~repro_torch.core.wavefront.wfa_bidir_meet`, via the engine-level
   ``"bidir_meet"`` output) and splits at the returned (diagonal, offset),
   with the affine open/extend joint handled by boundary states: a split
   inside a gap run pins the left child's end and the right child's begin
   to ``"I"``/``"D"`` so the open is charged exactly once.
3. **stitch + verify** — children's op arrays concatenate in tree order;
   every stitched root is re-scored host-side (``gotoh.score_cigar``)
   against the phase-1 cost.  Any mismatch (the meet detector accepts some
   coverage overshoots opportunistically) falls back to one packed-trace
   re-run of the offending segment, so exactness never rests on the
   detector; fallbacks are counted in ``stats.n_bidir_fallback``.

Trace memory: the meet waves keep O(s)-deep rolling windows and the only
materialized backtraces are budget-capped base cases — O(s) resident trace
bytes total vs the packed path's O(s^2) (``stats.peak_trace_bytes``).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.core import gotoh
from repro_torch.core.engine import _round_up, pack_batch
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import record as obs_record
from repro_torch.obs import trace as obs_trace

__all__ = ["BidirDriver", "DEFAULT_TRACE_BUDGET"]

_OP_I, _OP_D = 2, 3

# Base-case threshold on s*(plen+tlen): ~4M cells keeps 1 kb pairs on the
# direct packed path (no recursion overhead in the short-read regime) while
# 10 kb+ noisy pairs recurse until their backtraces are a few hundred kB.
DEFAULT_TRACE_BUDGET = 1 << 22


class _Seg:
    """One node of a pair's recursion tree (half-open slices into the
    parent ticket's packed rows)."""
    __slots__ = ("row", "p_lo", "p_hi", "t_lo", "t_hi", "cost", "begin",
                 "end", "parent", "left", "right", "ops", "pending",
                 "fallback", "done", "depth")

    def __init__(self, row, p_lo, p_hi, t_lo, t_hi, cost, begin, end,
                 parent=None):
        self.row = row
        self.p_lo, self.p_hi = p_lo, p_hi
        self.t_lo, self.t_hi = t_lo, t_hi
        self.cost = cost          # forward-convention cost of this segment
        self.begin, self.end = begin, end
        self.parent = parent
        self.depth = 0 if parent is None else parent.depth + 1
        self.left = self.right = None
        self.ops: Optional[np.ndarray] = None
        self.pending = 0          # unresolved children (0 or 2)
        self.fallback = False     # already re-run via packed trace once
        self.done = False         # roots only: row finished


class BidirDriver:
    """Meet-in-the-middle traceback driver for one bidir CIGAR ticket."""

    def __init__(self, session, ticket, trace_budget: Optional[int] = None):
        self.sess = session
        self.ticket = ticket
        eng = session.engine
        budget = eng.trace_budget if trace_budget is None else trace_budget
        self.budget = DEFAULT_TRACE_BUDGET if budget is None else int(budget)
        pen = ticket.pen
        affine = pen.kind == "affine"
        self.o = pen.o if affine else 0
        maxop = max(pen.x, pen.o + pen.e) if affine else max(pen.x, pen.e)
        # detection window of the meet solver (see wfa_bidir_meet): the
        # lockstep loop needs ~(T+o)/2 + wd steps to cover every split
        self.wd = max(pen.window, 2 * maxop + 2)
        # own references: the parent ticket's packed arrays are nulled at
        # finalize, but stitching outlives retirement
        self._p, self._t = ticket._p, ticket._t
        self._plen, self._tlen = ticket._plen, ticket._tlen
        self._groups: dict = {}   # (kind, begin, end) -> [_Seg]

    # -- phases --------------------------------------------------------------

    def start(self) -> None:
        """Phase 1: resolve every pair's cost with a score-only ticket."""
        t = self.ticket
        self.sess.submit_packed(
            self._p, self._plen, self._t, self._tlen, output="score",
            penalties=t.pen, heuristic=t.heur, trace_variant="packed",
            _internal=True, _on_done=self._phase0_done, _flows=t.flows)

    def _merge_stats(self, child) -> None:
        """Fold an internal child ticket's telemetry into the parent's, so
        the bidir result reports the full cost (and the trace-memory
        high-water mark) of its whole recursion.  ``count_pairs=False``:
        the children's rows re-process pairs the parent already counted."""
        self.ticket.stats.merge(child.stats, count_pairs=False)

    def _phase0_done(self, st) -> None:
        self._merge_stats(st)
        for r in range(self.ticket.n_pairs):
            sc = int(st._scores[r])
            root = _Seg(r, 0, int(self._plen[r]), 0, int(self._tlen[r]),
                        sc, "M", "M")
            if sc < 0:             # unresolved even by the score pass
                self._finish_row(root, failed=True)
            else:
                self._classify(root)
        self._flush()

    # -- segment routing -----------------------------------------------------

    def _classify(self, seg: _Seg) -> None:
        """Resolve trivially, base-case to packed, or queue a meet wave."""
        n, m = seg.p_hi - seg.p_lo, seg.t_hi - seg.t_lo
        if n == 0:
            self._resolve(seg, np.full(m, _OP_I, np.int32))
        elif m == 0:
            self._resolve(seg, np.full(n, _OP_D, np.int32))
        elif (seg.cost == 0 and n == m and seg.begin == "M"
                and seg.end == "M"):
            self._resolve(seg, np.zeros(n, np.int32))     # pure match run
        elif (seg.fallback or seg.cost * (n + m) <= self.budget
                or seg.cost <= 2 * self.wd):
            self._groups.setdefault(("cigar", seg.begin, seg.end),
                                    []).append(seg)
        else:
            self._groups.setdefault(("meet", seg.begin, seg.end),
                                    []).append(seg)

    def _flush(self) -> None:
        """Dispatch queued segments, one internal ticket per (kind, states)
        group (boundary states are executable-static)."""
        groups, self._groups = self._groups, {}
        t = self.ticket
        for (kind, b, e), segs in groups.items():
            p, plen = pack_batch([self._p[s.row, s.p_lo:s.p_hi]
                                  for s in segs])
            tx, tlen = pack_batch([self._t[s.row, s.t_lo:s.t_hi]
                                   for s in segs])
            costs = np.asarray([s.cost for s in segs], np.int32)
            if kind == "cigar":
                # children run at their known cost, not the bucket worst
                # case (quantized for executable-cache reuse)
                cap = _round_up(max(int(costs.max(initial=0)), 1), 32)
                self.sess.submit_packed(
                    p, plen, tx, tlen, output="cigar", penalties=t.pen,
                    heuristic=t.heur, trace_variant="packed", meta=segs,
                    _s_cap=cap, _states=(b, e), _internal=True,
                    _on_done=self._cigar_done, _flows=t.flows)
            else:
                cap = _round_up((int(costs.max(initial=0)) + self.o) // 2
                                + self.wd + 2, 32)
                self.sess.submit_packed(
                    p, plen, tx, tlen, penalties=t.pen, heuristic=t.heur,
                    meta=segs, _starget=costs, _s_cap=cap, _states=(b, e),
                    _internal=True, _on_done=self._meet_done,
                    _flows=t.flows)

    # -- child completions ---------------------------------------------------

    def _meet_done(self, mt) -> None:
        self._merge_stats(mt)
        segs: List[_Seg] = mt.meta
        with obs_trace.span("bidir.split", cat="biwfa",
                            args={"segments": len(segs)}
                            if obs_trace.enabled() else None):
            self._split_segs(mt, segs)
        self._flush()

    def _split_segs(self, mt, segs: List[_Seg]) -> None:
        for i, seg in enumerate(segs):
            state = int(mt._meet[i, 0])
            a = int(mt._meet[i, 1])
            k, h = int(mt._meet[i, 3]), int(mt._meet[i, 4])
            n, m = seg.p_hi - seg.p_lo, seg.t_hi - seg.t_lo
            v = h - k
            if (int(mt._scores[i]) < 0 or state < 0
                    or not (0 <= v <= n and 0 <= h <= m)
                    or (v == 0 and h == 0) or (v == n and h == m)
                    or not (0 <= a <= seg.cost)):
                # fronts never joined (or a degenerate no-progress split):
                # this segment goes back through the packed path
                self._fallback(seg)
                continue
            jst = ("M", "I", "D")[state]
            left = _Seg(seg.row, seg.p_lo, seg.p_lo + v,
                        seg.t_lo, seg.t_lo + h, a, seg.begin, jst,
                        parent=seg)
            right = _Seg(seg.row, seg.p_lo + v, seg.p_hi,
                         seg.t_lo + h, seg.t_hi, seg.cost - a, jst,
                         seg.end, parent=seg)
            seg.left, seg.right = left, right
            seg.pending = 2
            obs_metrics.counter("bidir_splits_total",
                                "BiWFA segments split at a meet "
                                "breakpoint").inc()
            obs_trace.counter("bidir_recursion_depth", left.depth,
                              cat="biwfa")
            self._classify(left)
            self._classify(right)

    def _cigar_done(self, ct) -> None:
        self._merge_stats(ct)
        segs: List[_Seg] = ct.meta
        with obs_trace.span("bidir.stitch", cat="biwfa",
                            args={"segments": len(segs)}
                            if obs_trace.enabled() else None):
            for i, seg in enumerate(segs):
                if int(ct._scores[i]) < 0:
                    self._fallback(seg)
                    continue
                self._resolve(seg, ct._cigars[i])
        self._flush()

    def _fallback(self, seg: _Seg) -> None:
        for st in (self.ticket.stats, self.sess.stats):
            st.n_bidir_fallback += 1
        obs_record.dump("bidir_fallback",
                        {"row": seg.row, "depth": seg.depth,
                         "cost": int(seg.cost)})
        if seg.fallback:
            # the packed path itself came back unresolved: give up on the
            # row (same -1 contract as the packed trace under a pinned
            # s_max or a pruning heuristic)
            self._fail_row(seg)
            return
        seg.fallback = True
        seg.left = seg.right = None
        seg.pending = 0
        self._classify(seg)

    # -- stitching -----------------------------------------------------------

    def _resolve(self, seg: _Seg, ops: np.ndarray) -> None:
        """Record one segment's ops and propagate completed joins upward."""
        seg.ops = ops
        while seg.parent is not None:
            par = seg.parent
            par.pending -= 1
            if par.pending > 0:
                return
            if par.left.ops is None or par.right.ops is None:
                return            # sibling died and the row already failed
            par.ops = np.concatenate([par.left.ops, par.right.ops])
            par.left = par.right = None
            seg = par
        self._root_done(seg)

    def _root_done(self, root: _Seg) -> None:
        if root.done:
            return
        r = root.row
        pat = self._p[r, :int(self._plen[r])]
        txt = self._t[r, :int(self._tlen[r])]
        cost, ci, cj, ok = gotoh.score_cigar(root.ops, pat, txt,
                                             self.ticket.pen)
        exact = self.ticket.heur.exact
        good = (ok and ci == len(pat) and cj == len(txt)
                and (cost == root.cost or not exact))
        if not good and not root.fallback:
            # opportunistic breakpoint landed wrong: one whole-pair packed
            # re-run (the O(s^2) escape hatch) keeps the exactness contract
            for st in (self.ticket.stats, self.sess.stats):
                st.n_bidir_fallback += 1
            root.fallback = True
            root.ops = None
            self._classify(root)
            return
        if not good:
            self._finish_row(root, failed=True)
        else:
            # heuristic mode reports the realized (re-scored) cost, which
            # may beat the pruned score pass's bound
            self._finish_row(root, score=cost if not exact else root.cost)

    def _fail_row(self, seg: _Seg) -> None:
        while seg.parent is not None:
            seg = seg.parent
        self._finish_row(seg, failed=True)

    def _finish_row(self, root: _Seg, failed: bool = False,
                    score: Optional[int] = None) -> None:
        if root.done:
            return
        root.done = True
        t = self.ticket
        t._scores[root.row] = -1 if failed else int(score)
        t._cigars[root.row] = (np.zeros(0, np.int32) if failed
                               else root.ops)
        t._outstanding -= 1
        self.sess._maybe_finish(t)

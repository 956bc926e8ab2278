"""Batched WFA extension of candidate loci through the streaming engine.

The verification stage: each ranked
:class:`~repro_torch.mapping.chain.Chain` is turned into one (reference
window, strand-adjusted read) pair and pushed through
``AlignmentEngine.stream()`` in CIGAR mode — bucketed batching,
executable caching, overflow recovery and out-of-order gather all come
from the session layer for free, and every alignment the mapper reports
went through the same engine as plain pairwise traffic (no second
alignment entry point).

Windows are cut to ``read_len + 2*delta`` around the chain's diagonal
(``delta = ceil(edit_frac * read_len) + extra_pad`` absorbs indel drift
and the diagonal estimate error), so extension problems land in the same
length buckets as the paper's pairwise workload — the mappings/sec vs
pairs/sec benchmark ratio is a like-for-like comparison.  The global
alignment against the slightly-wider window starts and ends with forced
deletion runs; those are trimmed off the CIGAR and their gap cost off the
score, which yields the SAM ``POS`` (window start + leading trim) and a
cost that re-scores exactly against ``ref[POS : POS + ref_span]``.

Ticket metadata carries the per-row ``(read_id, locus, strand)`` records
(the session treats it as opaque), so ``as_completed()`` retires whole
reads out of order: a read whose extensions overflowed into the recovery
queue does not stall reads submitted after it.

MAPQ is the best-vs-second-best gap: with best trimmed cost ``c1`` and
runner-up ``c2`` (across this read's verified candidates),

    MAPQ = 60                                     (single candidate)
    MAPQ = min(60, round(20 * (c2 - c1) / unit))  (otherwise)

where ``unit = pen.unit_cost()`` (the cost of one isolated edit) — 0 when
tied, saturating at 60 once the runner-up is ~3 edits worse.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import scoring
from repro_torch.core.cigar import OP_D, OP_I, OP_M
from repro_torch.core.engine import AlignmentEngine, EngineStats
from repro_torch.data.dna import as_ascii, revcomp
from repro_torch.obs import trace as obs_trace
from repro_torch.mapping.chain import Chain, candidates
from repro_torch.mapping.index import MinimizerIndex

__all__ = ["Mapping", "MapperStats", "ReadMapper", "suggested_edit_frac"]


@dataclasses.dataclass
class Mapping:
    """One reported alignment of a read onto the reference set.

    ``ref_id == -1`` means unmapped (no candidate locus, or none of the
    candidates produced an alignment).  ``pos`` is the 0-based leftmost
    reference position (:mod:`repro_torch.mapping.sam` adds SAM's +1);
    ``ops`` the trimmed CIGAR op array (``core.cigar`` codes) of the
    strand-adjusted read against the forward reference; ``score`` its
    alignment cost, which re-scores exactly against
    ``ref[pos : pos + ref_span]``.
    """
    read_id: int
    ref_id: int = -1
    pos: int = -1
    strand: int = 0
    mapq: int = 0
    score: int = -1
    ops: Optional[np.ndarray] = None
    chain_score: float = 0.0
    n_candidates: int = 0
    secondary: bool = False
    approximate: bool = False

    @property
    def mapped(self) -> bool:
        return self.ref_id >= 0

    def ref_span(self) -> int:
        """Reference bases consumed (M/X/D ops) — the SAM span."""
        if self.ops is None:
            return 0
        return int((self.ops != OP_I).sum())     # M/X/D all consume ref


@dataclasses.dataclass
class MapperStats:
    """Telemetry for one ``map_stream``/``map`` pass."""
    n_reads: int = 0
    n_mapped: int = 0
    n_candidates: int = 0      # chains submitted for extension
    n_unresolved: int = 0      # extensions that came back score == -1
    n_tickets: int = 0
    # engine-side telemetry aggregated across every extension ticket
    # (EngineStats.merge per retirement — scatter/kernel/gather time,
    # cache behaviour, overflow recovery for the whole pass)
    engine: EngineStats = dataclasses.field(default_factory=EngineStats)

    @property
    def n_extensions(self) -> int:
        """Pairs through the engine — one per candidate, by construction."""
        return self.n_candidates

    @property
    def candidates_per_read(self) -> float:
        return self.n_candidates / max(self.n_reads, 1)


def suggested_edit_frac(pen, edit_frac: float, read_len: int,
                        extra_pad: int = 1) -> float:
    """Engine ``edit_frac`` sizing the optimistic pass for extension pairs.

    An extension problem costs up to ``ceil(E*L)`` read edits *plus* two
    forced end-deletion runs into the padded window (up to ``2*delta``
    trimmed bases total).  This returns the smallest E' whose engine-side
    score bound covers that, so the common case resolves in pass 1 and
    only genuinely divergent candidates hit the recovery queue.
    """
    pen = scoring.as_model(pen)
    delta = int(math.ceil(edit_frac * read_len)) + extra_pad
    need = (int(math.ceil(edit_frac * read_len)) * pen.unit_cost()
            + 2 * pen.gap_cost(2 * delta))
    # engine bound at length lmax >= wlen: n*(unit + e) + o + slack,
    # n = ceil(E' * lmax); solve for n at the tightest lmax
    n = max(1, math.ceil((need - pen.o) / (pen.unit_cost() + pen.e)))
    return n / max(read_len + 2 * delta, 1)


@dataclasses.dataclass(frozen=True)
class _Cand:
    """Per-row ticket metadata: which read/locus/strand this row verifies."""
    read_id: int
    chain: Chain
    wstart: int                # window start on the forward reference
    wlen: int                  # window length (re-slices the reference)
    text: np.ndarray           # strand-adjusted read (ASCII uint8)


class ReadMapper:
    """Seed-chain-extend mapper over one index + one alignment engine.

    Parameters
    ----------
    index : the shared :class:`MinimizerIndex`.
    engine : the :class:`AlignmentEngine` all extensions go through.
        ``None`` builds one on ``backend`` and ``device``, sized for this
        mapper's ``edit_frac``/``read_len`` regime
        (:func:`suggested_edit_frac`).
    top_n : candidate loci verified per read (primary + secondaries).
    edit_frac : expected read divergence E — sizes windows and (for an
        auto-built engine) the optimistic score bound.
    extra_pad : window slack beyond ``ceil(E*L)`` for the chain's
        diagonal-estimate error.
    batch_reads : reads per session submit (one ticket's worth).
    penalties / heuristic : per-submit scoring seam, forwarded to every
        ``submit()`` (``None`` = engine defaults).
    trace_variant : traceback seam, forwarded the same way — pass
        ``"bidir"`` for long-read extension (ONT/PacBio windows), where
        the packed backtrace's O(s^2) trace memory is the binding
        constraint; short-read mapping keeps the default packed path.
    min_chain_score / max_gap : chaining thresholds (``None`` -> ``k``).
    backend / device : the auto-built engine's backend and device
        (``device=None`` means the card, as for ``AlignmentEngine``);
        ignored when ``engine`` is given.
    """

    def __init__(self, index: MinimizerIndex,
                 engine: Optional[AlignmentEngine] = None, *,
                 top_n: int = 2, edit_frac: float = 0.02,
                 extra_pad: int = 1, read_len: int = 100,
                 batch_reads: int = 256, penalties=None, heuristic=None,
                 trace_variant: Optional[str] = None,
                 min_chain_score: Optional[float] = None,
                 max_gap: int = 200, backend: str = "ring",
                 device=None):
        if top_n < 1:
            raise ValueError(f"need top_n >= 1: {top_n}")
        self.index = index
        self.top_n = int(top_n)
        self.edit_frac = float(edit_frac)
        self.extra_pad = int(extra_pad)
        self.batch_reads = int(batch_reads)
        self.penalties = penalties
        self.heuristic = heuristic
        self.trace_variant = trace_variant
        self.max_gap = int(max_gap)
        self.min_chain_score = (float(index.k) if min_chain_score is None
                                else float(min_chain_score))
        if engine is None:
            pen = scoring.as_model(penalties)
            engine = AlignmentEngine(
                pen, backend=backend,
                edit_frac=suggested_edit_frac(pen, edit_frac, read_len,
                                              extra_pad),
                device=device)
        self.engine = engine
        self.pen = engine.resolve_penalties(penalties)
        self.stats = MapperStats()

    # -- window geometry -----------------------------------------------------

    def _window(self, c: Chain, read_len: int) -> Tuple[np.ndarray, int]:
        """Reference window around the chain's diagonal -> (bases, start)."""
        ref = self.index.seqs[c.ref_id]
        delta = int(math.ceil(self.edit_frac * read_len)) + self.extra_pad
        wstart = max(0, c.diag - delta)
        wend = min(len(ref), c.diag + read_len + delta)
        wstart = min(wstart, max(0, wend - 1))
        return ref[wstart:wend], wstart

    # -- mapping -------------------------------------------------------------

    def map_stream(self, reads: Sequence, *,
                   max_inflight_waves: int = 2) -> Iterator[List[Mapping]]:
        """Map reads, yielding one ``[primary, *secondaries]`` list per read
        **in completion order** (not submission order — ``read_id`` says
        which read a list belongs to).

        Reads without any candidate locus yield an unmapped
        :class:`Mapping` immediately; everything else is submitted in
        ``batch_reads`` chunks and retired as its ticket completes.
        Resets and fills ``self.stats``.
        """
        self.stats = MapperStats()
        stats = self.stats
        eng = self.engine
        with eng.stream(max_inflight_waves=max_inflight_waves) as sess:
            pats: List[np.ndarray] = []
            texts: List[np.ndarray] = []
            metas: List[_Cand] = []
            reads_in_batch = 0

            def flush():
                nonlocal pats, texts, metas, reads_in_batch
                if metas:
                    sess.submit(pats, texts, output="cigar",
                                penalties=self.penalties,
                                heuristic=self.heuristic,
                                trace_variant=self.trace_variant,
                                meta=metas)
                    stats.n_tickets += 1
                pats, texts, metas = [], [], []
                reads_in_batch = 0

            for rid, read in enumerate(reads):
                read = as_ascii(read)
                stats.n_reads += 1
                with obs_trace.span("map.seed_chain", cat="mapping",
                                    args={"read": rid}
                                    if obs_trace.enabled() else None):
                    chains = candidates(self.index, read, top_n=self.top_n,
                                        max_gap=self.max_gap,
                                        min_score=self.min_chain_score)
                if not chains:
                    yield [Mapping(read_id=rid)]
                    continue
                stats.n_candidates += len(chains)
                rc = None
                for c in chains:
                    if c.strand and rc is None:
                        rc = revcomp(read)
                    window, wstart = self._window(c, len(read))
                    text = read if c.strand == 0 else rc
                    pats.append(window)
                    texts.append(text)
                    metas.append(_Cand(read_id=rid, chain=c, wstart=wstart,
                                       wlen=len(window), text=text))
                reads_in_batch += 1
                if reads_in_batch >= self.batch_reads:
                    flush()
            flush()
            for ticket in sess.as_completed():
                yield from self._retire(ticket)

    def map(self, reads: Sequence) -> List[List[Mapping]]:
        """Map reads -> per-read ``[primary, *secondaries]`` lists in input
        order (the blocking convenience wrapper over :meth:`map_stream`)."""
        out: List[Optional[List[Mapping]]] = [None] * len(reads)
        for maps in self.map_stream(reads):
            out[maps[0].read_id] = maps
        return out    # every read yields exactly once

    # -- retirement ----------------------------------------------------------

    def _retire(self, ticket) -> Iterator[List[Mapping]]:
        """Turn one completed ticket into per-read mapping lists."""
        res = ticket.result()
        stats = self.stats
        stats.engine.merge(ticket.stats)
        out: List[List[Mapping]] = []
        # the span closes before anything is yielded: it measures trim /
        # rank / MAPQ work, not the consumer's time between yields
        with obs_trace.span("map.retire", cat="mapping",
                            args={"ticket": ticket.index,
                                  "rows": ticket.n_pairs}
                            if obs_trace.enabled() else None):
            by_read: dict = {}
            for row, cand in enumerate(ticket.meta):
                by_read.setdefault(cand.read_id, []).append((row, cand))
            for rid, rows in by_read.items():
                scored = []
                for row, cand in rows:
                    s = int(res.scores[row])
                    if s < 0:
                        stats.n_unresolved += 1
                        continue
                    ops, lead, trimmed = self._trim(res.cigars[row], cand)
                    scored.append((s - trimmed, cand, ops, lead))
                if not scored:
                    out.append([Mapping(read_id=rid, n_candidates=len(rows))])
                    continue
                scored.sort(key=lambda t: (t[0], -t[1].chain.score))
                second = scored[1][0] if len(scored) > 1 else None
                maps = []
                for rank, (cost, cand, ops, lead) in enumerate(scored):
                    c = cand.chain
                    maps.append(Mapping(
                        read_id=rid, ref_id=c.ref_id,
                        pos=cand.wstart + lead, strand=c.strand,
                        mapq=(self._mapq(cost, second) if rank == 0 else 0),
                        score=cost, ops=ops, chain_score=c.score,
                        n_candidates=len(rows), secondary=rank > 0,
                        approximate=res.approximate))
                stats.n_mapped += 1
                out.append(maps)
        yield from out

    def _trim(self, ops: np.ndarray,
              cand: "_Cand") -> Tuple[np.ndarray, int, int]:
        """Strip forced end-deletion runs -> (ops, lead_len, cost_removed).

        The global alignment against the padded window opens a deletion
        run wherever the read starts/ends inside the window; trimming it
        recovers the local placement (POS) and its gap cost.  Global
        optima are not unique though: when a few read-edge bases happen to
        match the window *before* the forced gap (``2M 6D 98M`` instead of
        ``6D 100M``), the gap lands one run inboard and naive trimming
        would keep paying for it — so end M-runs are first slid across an
        adjacent D-run whenever the matched bases still match at the
        shifted reference position (a pure tie-break: the global cost is
        unchanged, the trimmed cost and POS improve).
        """
        ops = np.asarray(ops)
        ref = self.index.seqs[cand.chain.ref_id]
        window = ref[cand.wstart: cand.wstart + cand.wlen]
        ops = self._slide_ends(ops, window, cand.text)
        non_d = np.flatnonzero(ops != OP_D)
        if non_d.size == 0:
            return ops[:0], len(ops), self.pen.gap_cost(len(ops))
        i0, i1 = int(non_d[0]), int(non_d[-1]) + 1
        removed = (self.pen.gap_cost(i0) + self.pen.gap_cost(len(ops) - i1))
        return ops[i0:i1], i0, removed

    @staticmethod
    def _run_len(ops: np.ndarray, op: int) -> int:
        """Length of the leading run of ``op`` in ``ops``."""
        other = np.flatnonzero(ops != op)
        return int(other[0]) if other.size else len(ops)

    @classmethod
    def _slide_ends(cls, ops: np.ndarray, window: np.ndarray,
                    text: np.ndarray) -> np.ndarray:
        """Rotate end M-runs across the adjacent D-run when bases allow."""
        n = len(ops)
        # left edge: [a M][d D]... -> [d D][a M]... iff text[:a] matches
        # the window at the post-gap position
        a = cls._run_len(ops, OP_M)
        d = cls._run_len(ops[a:], OP_D) if 0 < a < n else 0
        if a and d and np.array_equal(text[:a], window[d: d + a]):
            ops = ops.copy()
            ops[:d] = OP_D
            ops[d: d + a] = OP_M
        # right edge: ...[d D][b M] -> ...[b M][d D] iff the trailing text
        # bases match the window at the pre-gap position
        b = cls._run_len(ops[::-1], OP_M)
        d = cls._run_len(ops[:n - b][::-1], OP_D) if 0 < b < n else 0
        if b and d:
            j = n - b - d
            # window offset of the D run start = ref bases consumed before
            r0 = int((ops[:j] != OP_I).sum())
            if np.array_equal(text[len(text) - b:], window[r0: r0 + b]):
                ops = ops.copy()
                ops[j: j + b] = OP_M
                ops[j + b:] = OP_D
        return ops

    def _mapq(self, best: int, second: Optional[int]) -> int:
        if second is None:
            return 60
        gap = second - best
        if gap <= 0:
            return 0
        return min(60, int(round(20.0 * gap / self.pen.unit_cost())))

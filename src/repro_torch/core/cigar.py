"""WFA traceback: wavefront provenance -> CIGAR op sequences.

Two trace encodings come off the device (``core.wavefront``):

* **full history** — three ``[s_max+1, B, K]`` int32 offset arrays
  (``wfa_forward(keep_history=True)``, the ``ref`` backend).  Traceback is
  the classic pointer chase over stored offsets.
* **packed backtrace** — three ``[n_trace_words, B, K]`` int32 arrays of
  2-bit per-cell provenance codes (``wfa_scores_packed`` / the CUDA trace
  kernel), ~16x smaller.  Traceback decodes the packed words into the edit
  chain (phase A: walk codes from the end cell back to the origin), then
  replays that chain forward, re-deriving every match run by greedy
  extension against the sequences (phase B).  This is exact: each stored M
  wavefront value is the *maximal* extension, so replaying maximal LCP
  extension at every M-cell entry reproduces the forward offsets bit for
  bit.

Both encodings are **per penalty model** (``core.scoring``): gap-affine
traces walk the three-matrix M/I/D provenance, while linear models
(``GapLinear`` / ``Edit``) come off the device with a single M plane and
walk the one-matrix chain (every gap op sources M directly at cost ``e``).
Every decode is exact for the trace it is given — including traces
produced under a wavefront heuristic, whose *scores* are approximate but
whose provenance chains are internally consistent (pruned lanes are
unreachable: no surviving cell derives from one).

Traceback is a data-dependent walk, so (like the reference WFA2-lib, and
like the paper's host-side result handling) it runs on the host in numpy.
Malformed provenance (a bug, or corrupted words) raises
:class:`TracebackError` carrying the failing coordinates — never a bare
``assert`` (those are stripped under ``python -O``).

Op codes match ``core.gotoh.score_cigar``: 0=M(match) 1=X(mismatch)
2=I(insert, consumes text) 3=D(delete, consumes pattern); -1 = padding.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.core import scoring
from repro_torch.core.wavefront import (BT_GAP_EXT, BT_GAP_OPEN,
                                        BT_M_FROM_D, BT_M_FROM_I,
                                        BT_M_FROM_X, NEG,
                                        TRACE_CELLS_PER_WORD, _VALID_THRESH)

OP_M, OP_X, OP_I, OP_D = 0, 1, 2, 3

_OP_CHARS_EXT = {OP_M: "=", OP_X: "X", OP_I: "I", OP_D: "D"}   # SAM 1.4
_OP_CHARS_CLASSIC = {OP_M: "M", OP_X: "M", OP_I: "I", OP_D: "D"}


class TracebackError(RuntimeError):
    """Inconsistent wavefront provenance during traceback.

    Carries the failing coordinates: ``pair`` (batch row), ``s`` (score),
    ``k`` (diagonal) and ``h`` (text offset, when known) so a corrupted
    trace pinpoints the cell instead of dying in a bare assert (which
    ``python -O`` would strip entirely).
    """

    def __init__(self, msg: str, *, pair: Optional[int] = None,
                 s: Optional[int] = None, k: Optional[int] = None,
                 h: Optional[int] = None):
        self.pair, self.s, self.k, self.h = pair, s, k, h
        where = ", ".join(f"{n}={v}" for n, v in
                          (("pair", pair), ("s", s), ("k", k), ("h", h))
                          if v is not None)
        super().__init__(f"{msg} ({where})" if where else msg)


# ---------------------------------------------------------------------------
# Full-history traceback (ref backend): pointer chase over stored offsets.


def _get(hist, s, k, k_max):
    K = hist.shape[-1]
    j = k + k_max
    if s < 0 or j < 0 or j >= K:
        return NEG
    return int(hist[s, j])


def traceback_one(m_hist, i_hist, d_hist, pen, score: int,
                  plen: int, tlen: int, k_max: int,
                  pair: Optional[int] = None, begin_state: str = "M",
                  end_state: str = "M") -> np.ndarray:
    """Gap-affine traceback for one pair. hist arrays are [s_max+1, K].

    ``begin_state``/``end_state`` mirror the solver's boundary states
    (BiWFA sub-alignments): the walk starts in ``end_state`` and may
    terminate on the gap seed cell ``I_0[0] = 0`` / ``D_0[0] = 0``
    (inherited open gap, no op of its own) instead of the M origin.
    """
    if score < 0:
        return np.empty((0,), np.int8)
    pen = scoring.as_model(pen)
    x, o, e = pen.x, pen.o, pen.e
    ops: list[int] = []          # built back-to-front
    state = end_state
    s = int(score)
    k = tlen - plen
    h = tlen
    guard = 4 * (plen + tlen) + 4 * (s + 1) + 8
    while guard > 0:
        guard -= 1
        if state == "M":
            if s == 0:
                if k != 0:
                    raise TracebackError("origin cell off diagonal 0",
                                         pair=pair, s=s, k=k, h=h)
                ops.extend([OP_M] * h)
                break
            cand_x = _get(m_hist, s - x, k, k_max)
            cand_x = cand_x + 1 if cand_x > _VALID_THRESH else NEG
            i_val = _get(i_hist, s, k, k_max)
            d_val = _get(d_hist, s, k, k_max)
            pre = max(cand_x, i_val, d_val)
            if pre <= _VALID_THRESH or h < pre:
                raise TracebackError("no valid M predecessor",
                                     pair=pair, s=s, k=k, h=h)
            ops.extend([OP_M] * (h - pre))
            h = pre
            if pre == cand_x:
                ops.append(OP_X)
                s -= x
                h -= 1
                # stay in M
            elif pre == i_val:
                state = "I"
            else:
                state = "D"
        elif state == "I":
            if s == 0:
                # gap seed cell (begin_state="I"): inherited open gap,
                # carries no op
                if begin_state != "I" or k != 0 or h != 0:
                    raise TracebackError("I chain hit s=0 off the gap seed",
                                         pair=pair, s=s, k=k, h=h)
                break
            ext = _get(i_hist, s - e, k - 1, k_max) if s >= e else NEG
            ext = ext + 1 if ext > _VALID_THRESH else NEG
            ops.append(OP_I)
            if ext > _VALID_THRESH and h == ext:
                s -= e
                k -= 1
                h -= 1
                # stay in I (gap extension)
            else:
                opn = _get(m_hist, s - o - e, k - 1, k_max)
                if opn <= _VALID_THRESH or h != opn + 1:
                    raise TracebackError("no valid I predecessor",
                                         pair=pair, s=s, k=k, h=h)
                s -= o + e
                k -= 1
                h -= 1
                state = "M"
        else:  # "D"
            if s == 0:
                if begin_state != "D" or k != 0 or h != 0:
                    raise TracebackError("D chain hit s=0 off the gap seed",
                                         pair=pair, s=s, k=k, h=h)
                break
            ext = _get(d_hist, s - e, k + 1, k_max) if s >= e else NEG
            ops.append(OP_D)
            if ext > _VALID_THRESH and h == ext:
                s -= e
                k += 1
                # stay in D
            else:
                opn = _get(m_hist, s - o - e, k + 1, k_max)
                if opn <= _VALID_THRESH or h != opn:
                    raise TracebackError("no valid D predecessor",
                                         pair=pair, s=s, k=k, h=h)
                s -= o + e
                k += 1
                state = "M"
    else:
        raise TracebackError("traceback did not terminate",
                             pair=pair, s=s, k=k, h=h)
    return np.asarray(ops[::-1], np.int8)


def traceback_linear_one(m_hist, pen, score: int, plen: int, tlen: int,
                         k_max: int, pair: Optional[int] = None) -> np.ndarray:
    """One-matrix (gap-linear / edit) traceback for one pair.

    With no gap-open cost there are no I/D states: every op (mismatch,
    insertion, deletion) sources M directly — mismatch at ``s - x`` on the
    same diagonal, gaps at ``s - e`` on the neighbouring diagonals.
    """
    if score < 0:
        return np.empty((0,), np.int8)
    model = scoring.as_model(pen)
    x, e = model.x, model.e
    ops: list[int] = []          # built back-to-front
    s = int(score)
    k = tlen - plen
    h = tlen
    guard = 4 * (plen + tlen) + 4 * (s + 1) + 8
    while guard > 0:
        guard -= 1
        if s == 0:
            if k != 0:
                raise TracebackError("origin cell off diagonal 0",
                                     pair=pair, s=s, k=k, h=h)
            ops.extend([OP_M] * h)
            break
        cand_x = _get(m_hist, s - x, k, k_max)
        cand_x = cand_x + 1 if cand_x > _VALID_THRESH else NEG
        cand_i = _get(m_hist, s - e, k - 1, k_max)
        cand_i = cand_i + 1 if cand_i > _VALID_THRESH else NEG
        cand_d = _get(m_hist, s - e, k + 1, k_max)
        pre = max(cand_x, cand_i, cand_d)
        if pre <= _VALID_THRESH or h < pre:
            raise TracebackError("no valid M predecessor",
                                 pair=pair, s=s, k=k, h=h)
        ops.extend([OP_M] * (h - pre))
        h = pre
        if pre == cand_x:
            ops.append(OP_X)
            s -= x
            h -= 1
        elif pre == cand_i:
            ops.append(OP_I)
            s -= e
            k -= 1
            h -= 1
        else:
            ops.append(OP_D)
            s -= e
            k += 1
    else:
        raise TracebackError("traceback did not terminate",
                             pair=pair, s=s, k=k, h=h)
    return np.asarray(ops[::-1], np.int8)


def traceback_batch(result, pen, plen, tlen, k_max: int,
                    begin_state: str = "M", end_state: str = "M"):
    """-> list of per-pair op arrays (ragged), dispatched on the model."""
    model = scoring.as_model(pen)
    m_h = np.asarray(result.m_hist)
    scores = np.asarray(result.score)
    plen = np.asarray(plen)
    tlen = np.asarray(tlen)
    if model.kind == "linear":
        if begin_state != "M" or end_state != "M":
            raise ValueError("linear models have no I/D boundary states")
        return [
            traceback_linear_one(m_h[:, b], model, int(scores[b]),
                                 int(plen[b]), int(tlen[b]), k_max, pair=b)
            for b in range(scores.shape[0])
        ]
    i_h = np.asarray(result.i_hist)
    d_h = np.asarray(result.d_hist)
    return [
        traceback_one(m_h[:, b], i_h[:, b], d_h[:, b], model, int(scores[b]),
                      int(plen[b]), int(tlen[b]), k_max, pair=b,
                      begin_state=begin_state, end_state=end_state)
        for b in range(scores.shape[0])
    ]


# ---------------------------------------------------------------------------
# Packed-backtrace traceback: decode 2-bit provenance words, replay forward.


def unpack_codes(words: np.ndarray, s_max: int) -> np.ndarray:
    """[n_words, ..., K] packed int32 -> [s_max+1, ..., K] uint8 codes.

    Vectorized word decode (tests and tooling; the traceback walk below
    decodes per-access instead, touching only the O(score) cells it visits).
    """
    words = np.asarray(words)
    s = np.arange(s_max + 1)
    w, off = s // TRACE_CELLS_PER_WORD, 2 * (s % TRACE_CELLS_PER_WORD)
    shaped = (slice(None),) + (None,) * (words.ndim - 1)
    return ((words[w] >> off[shaped]) & 3).astype(np.uint8)


def _code_at(words: np.ndarray, s: int, k: int, k_center: int) -> int:
    """2-bit code of cell (s, k) from one pair's [n_words, K] packed words."""
    j = k + k_center
    if s < 0 or j < 0 or j >= words.shape[-1] \
            or s // TRACE_CELLS_PER_WORD >= words.shape[0]:
        return 0
    return (int(words[s // TRACE_CELLS_PER_WORD, j])
            >> (2 * (s % TRACE_CELLS_PER_WORD))) & 3


def _lcp(p: np.ndarray, t: np.ndarray, v: int, h: int) -> int:
    """Greedy match run length of pattern[v:] vs text[h:] (vectorized)."""
    n = min(len(p) - v, len(t) - h)
    if n <= 0:
        return 0
    neq = np.flatnonzero(p[v:v + n] != t[h:h + n])
    return n if neq.size == 0 else int(neq[0])


def _replay(rev, p, t, plen: int, tlen: int,
            pair: Optional[int] = None, extend_start: bool = True) -> np.ndarray:
    """Phase B: replay a back-to-front edit chain forward, re-deriving each
    match run by maximal extension (exactly the forward pass's extend
    step).  ``rev`` holds ``(op, extend_after)`` pairs.  ``extend_start``
    is False when the chain terminated on a begin-state gap seed (the
    alignment opens mid-gap: no leading match run to re-derive)."""
    ops: list[int] = []
    v = h = 0
    if extend_start:
        r = _lcp(p, t, v, h)
        ops.extend([OP_M] * r)
        v += r
        h += r
    for op, extend_after in reversed(rev):
        if op == OP_X:
            if v >= plen or h >= tlen:
                raise TracebackError("mismatch op past sequence end",
                                     pair=pair, h=h)
            v += 1
            h += 1
        elif op == OP_I:
            if h >= tlen:
                raise TracebackError("insertion op past text end",
                                     pair=pair, h=h)
            h += 1
        else:  # OP_D
            if v >= plen:
                raise TracebackError("deletion op past pattern end",
                                     pair=pair, h=h)
            v += 1
        ops.append(op)
        if extend_after:
            r = _lcp(p, t, v, h)
            ops.extend([OP_M] * r)
            v += r
            h += r
    if v != plen or h != tlen:
        raise TracebackError(
            f"replay consumed ({v}, {h}) of ({plen}, {tlen})",
            pair=pair, h=h)
    return np.asarray(ops, np.int8)


def traceback_packed_one(m_bt, i_bt, d_bt, pen, score: int,
                         pattern, text, plen: int, tlen: int,
                         pair: Optional[int] = None, begin_state: str = "M",
                         end_state: str = "M") -> np.ndarray:
    """Gap-affine traceback for one pair from packed provenance words.

    ``m_bt/i_bt/d_bt`` are this pair's ``[n_words, K]`` int32 code words;
    ``pattern``/``text`` the (padded) integer code rows — needed because
    match runs are *replayed*, not stored.  The diagonal center is
    ``K // 2`` (true for both the ring layout ``K = 2*k_max+1`` and the
    kernel's lane-padded layout).

    ``begin_state``/``end_state`` mirror the solver's boundary states
    (BiWFA sub-alignments): the walk starts in ``end_state``; a
    begin-state gap chain terminates on the (codeless) gap seed cell at
    ``s = 0``, and replay then skips the leading match extension (the
    alignment opens mid-gap).
    """
    if score < 0:
        return np.empty((0,), np.int8)
    pen = scoring.as_model(pen)
    x, o, e = pen.x, pen.o, pen.e
    kc = m_bt.shape[-1] // 2
    p = np.asarray(pattern)[:plen]
    t = np.asarray(text)[:tlen]

    # Phase A: walk provenance codes from the end cell to the origin.
    # Emits the *edit* chain only (no match runs) back-to-front; each op is
    # tagged with whether forward replay re-enters an M cell after it (and
    # so must re-extend matches there).
    s, k, state = int(score), tlen - plen, end_state
    rev: list[tuple[int, bool]] = []          # (op, extend_after)
    close = False                             # next gap op folds into M
    extend_start = True
    guard = 4 * (plen + tlen) + 4 * (s + 1) + 8
    while guard > 0:
        guard -= 1
        if state == "M":
            if s == 0:
                if k != 0:
                    raise TracebackError("origin cell off diagonal 0",
                                         pair=pair, s=s, k=k)
                break
            c = _code_at(m_bt, s, k, kc)
            if c == BT_M_FROM_X:
                rev.append((OP_X, True))
                s -= x
            elif c == BT_M_FROM_I:
                state, close = "I", True
            elif c == BT_M_FROM_D:
                state, close = "D", True
            else:
                raise TracebackError("invalid M provenance code",
                                     pair=pair, s=s, k=k)
        elif state == "I":
            if s == 0:
                # begin-state gap seed: inherited open gap, no op, no
                # leading match run before it
                if begin_state != "I" or k != 0:
                    raise TracebackError("I chain hit s=0 off the gap seed",
                                         pair=pair, s=s, k=k)
                extend_start = False
                break
            c = _code_at(i_bt, s, k, kc)
            if c == 0:
                raise TracebackError("invalid I provenance code",
                                     pair=pair, s=s, k=k)
            rev.append((OP_I, close))
            close = False
            k -= 1
            if c == BT_GAP_EXT:
                s -= e
            else:
                s -= o + e
                state = "M"
        else:  # "D"
            if s == 0:
                if begin_state != "D" or k != 0:
                    raise TracebackError("D chain hit s=0 off the gap seed",
                                         pair=pair, s=s, k=k)
                extend_start = False
                break
            c = _code_at(d_bt, s, k, kc)
            if c == 0:
                raise TracebackError("invalid D provenance code",
                                     pair=pair, s=s, k=k)
            rev.append((OP_D, close))
            close = False
            k += 1
            if c == BT_GAP_EXT:
                s -= e
            else:
                s -= o + e
                state = "M"
    else:
        raise TracebackError("packed traceback did not terminate",
                             pair=pair, s=s, k=k)

    return _replay(rev, p, t, plen, tlen, pair=pair,
                   extend_start=extend_start)


def traceback_packed_linear_one(m_bt, pen, score: int, pattern, text,
                                plen: int, tlen: int,
                                pair: Optional[int] = None) -> np.ndarray:
    """One-matrix (gap-linear / edit) traceback from the single packed
    M-provenance plane: code 1 = mismatch (``s - x``, same diagonal),
    2 = insertion (``s - e``, diagonal k-1), 3 = deletion (``s - e``,
    diagonal k+1).  Every op returns to an M cell, so forward replay
    re-extends matches after each one.
    """
    if score < 0:
        return np.empty((0,), np.int8)
    model = scoring.as_model(pen)
    x, e = model.x, model.e
    kc = m_bt.shape[-1] // 2
    p = np.asarray(pattern)[:plen]
    t = np.asarray(text)[:tlen]

    s, k = int(score), tlen - plen
    rev: list[tuple[int, bool]] = []          # (op, extend_after)
    guard = 4 * (plen + tlen) + 4 * (s + 1) + 8
    while guard > 0:
        guard -= 1
        if s == 0:
            if k != 0:
                raise TracebackError("origin cell off diagonal 0",
                                     pair=pair, s=s, k=k)
            break
        c = _code_at(m_bt, s, k, kc)
        if c == BT_M_FROM_X:
            rev.append((OP_X, True))
            s -= x
        elif c == BT_M_FROM_I:
            rev.append((OP_I, True))
            s -= e
            k -= 1
        elif c == BT_M_FROM_D:
            rev.append((OP_D, True))
            s -= e
            k += 1
        else:
            raise TracebackError("invalid M provenance code",
                                 pair=pair, s=s, k=k)
    else:
        raise TracebackError("packed traceback did not terminate",
                             pair=pair, s=s, k=k)

    return _replay(rev, p, t, plen, tlen, pair=pair)


def traceback_packed_batch(result, pen, pattern, text, plen, tlen,
                           begin_state: str = "M", end_state: str = "M"):
    """-> list of per-pair op arrays (ragged) from packed provenance,
    dispatched on the model's recurrence kind."""
    model = scoring.as_model(pen)
    m_bt = np.asarray(result.m_bt)
    scores = np.asarray(result.score)
    pattern = np.asarray(pattern)
    text = np.asarray(text)
    plen = np.asarray(plen).reshape(-1)
    tlen = np.asarray(tlen).reshape(-1)
    if model.kind == "linear":
        if begin_state != "M" or end_state != "M":
            raise ValueError("linear models have no I/D boundary states")
        return [
            traceback_packed_linear_one(m_bt[:, b], model, int(scores[b]),
                                        pattern[b], text[b], int(plen[b]),
                                        int(tlen[b]), pair=b)
            for b in range(scores.shape[0])
        ]
    i_bt = np.asarray(result.i_bt)
    d_bt = np.asarray(result.d_bt)
    return [
        traceback_packed_one(m_bt[:, b], i_bt[:, b], d_bt[:, b], model,
                             int(scores[b]), pattern[b], text[b],
                             int(plen[b]), int(tlen[b]), pair=b,
                             begin_state=begin_state, end_state=end_state)
        for b in range(scores.shape[0])
    ]


def traceback_result(result, pen, *, pattern, text, plen, tlen,
                     k_max: int, begin_state: str = "M",
                     end_state: str = "M"):
    """Dispatch on the trace encoding a ``WFAResult`` carries.

    Full offset history (``ref``) -> pointer-chase traceback; packed
    provenance words (``ring``/``kernel``/``shardmap``) -> decode + replay.
    ``pen`` may be a legacy ``Penalties`` triple or any ``PenaltyModel``;
    linear models decode their single M plane.  ``begin_state`` /
    ``end_state`` select BiWFA sub-alignment boundaries (affine only).
    """
    if getattr(result, "m_hist", None) is not None:
        return traceback_batch(result, pen, plen, tlen, k_max,
                               begin_state=begin_state, end_state=end_state)
    if getattr(result, "m_bt", None) is not None:
        return traceback_packed_batch(result, pen, pattern, text, plen,
                                      tlen, begin_state=begin_state,
                                      end_state=end_state)
    raise ValueError("result carries no trace (score-only backend output); "
                     "run the backend's trace variant (output='cigar')")


def trace_nbytes(result) -> int:
    """Host-visible bytes of whichever trace encoding ``result`` carries."""
    total = 0
    for f in ("m_hist", "i_hist", "d_hist", "m_bt", "i_bt", "d_bt"):
        arr = getattr(result, f, None)
        if arr is not None:
            total += arr.size * arr.dtype.itemsize
    return total


# ---------------------------------------------------------------------------
# CIGAR formatting / summary helpers.


def run_length_string(ops: np.ndarray, chars: dict) -> str:
    """Run-length encode ops (-1 padding skipped) under an op->char map."""
    out = []
    run_c, run_n = None, 0
    for op in ops:
        op = int(op)
        if op < 0:
            continue
        c = chars[op]
        if c == run_c:
            run_n += 1
        else:
            if run_c is not None:
                out.append(f"{run_n}{run_c}")
            run_c, run_n = c, 1
    if run_c is not None:
        out.append(f"{run_n}{run_c}")
    return "".join(out)


def cigar_string(ops: np.ndarray, mode: str = "extended") -> str:
    """Run-length encode ops to a CIGAR string.

    ``mode="extended"`` (default) distinguishes matches and mismatches the
    SAM 1.4 way (``=`` / ``X``); ``mode="classic"`` folds both into ``M``
    (pre-1.4 CIGAR, what most downstream tools expect).
    """
    if mode == "extended":
        chars = _OP_CHARS_EXT
    elif mode == "classic":
        chars = _OP_CHARS_CLASSIC
    else:
        raise ValueError(f"unknown cigar mode {mode!r}; "
                         "use 'extended' or 'classic'")
    return run_length_string(ops, chars)


def cigar_identity(ops: np.ndarray) -> float:
    """Fraction of alignment columns that are matches (gaps count as
    columns; the read-mapping 'BLAST identity').  Empty alignments (both
    sequences empty) are identical by convention — callers must mask
    *unresolved* pairs (``score == -1``, also empty ops) themselves, as
    :meth:`EngineResult.cigar_identities` does (NaN)."""
    ops = np.asarray(ops)
    ops = ops[ops >= 0]
    if ops.size == 0:
        return 1.0
    return float((ops == OP_M).sum()) / float(ops.size)

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

Where the packed words are decoded follows where they are.  The
``kernel`` backend on a card decodes them there, right behind the trace
kernel (``kernels/wfa/csrc/wfa_traceback.cu``: the same walk and replay, a
warp a pair), and its result carries a third encoding:

* **decoded ops** — ``ops [B, L]`` int8 (each pair's ops, -1 padded),
  ``n_ops [B]`` and ``status [B, 4]`` (0, or the walk's or replay's error
  ``[code, s, k, h]``, :data:`TB_ERRORS`).  :func:`traceback_result` cuts
  each pair's ops out and raises the first error as the host walk would;
  :func:`decode_packed_plain` builds the same arrays on the host (the
  kernel's yardstick).

Every other trace (CPU tensors, the ``ring`` / ``ref`` / ``shardmap``
backends) is walked on the host in numpy, like the reference WFA2-lib and
the paper's host-side result handling.  Malformed provenance (a bug, or
corrupted words) raises :class:`TracebackError` carrying the failing
coordinates — never a bare ``assert`` (those are stripped under ``python
-O``).

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
from repro_torch.obs import trace as obs_trace

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
                 h: Optional[int] = None, v: Optional[int] = None):
        # v: the pattern offset of the replay's end check (in ``msg``)
        self.msg, self.pair, self.s, self.k, self.h, self.v = \
            msg, pair, s, k, h, v
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


# An edit of a chain is one int, ``op << 1 | extend_after``: whether forward
# replay re-enters an M cell after it (and so must re-extend matches there).
# Ints, not tuples, so a wave's chains held between its walk and its replay
# add no objects for the cyclic garbage collector to scan.
_X_EXT = OP_X << 1 | 1


def _replay(chain, p, t, plen: int, tlen: int,
            pair: Optional[int] = None, extend_start: bool = True) -> np.ndarray:
    """Phase B: replay a back-to-front edit chain forward, re-deriving each
    match run by maximal extension (exactly the forward pass's extend
    step).  ``chain`` holds ``op << 1 | extend_after`` ints.
    ``extend_start`` is False when the chain terminated on a begin-state
    gap seed (the alignment opens mid-gap: no leading match run to
    re-derive)."""
    ops: list[int] = []
    v = h = 0
    if extend_start:
        r = _lcp(p, t, v, h)
        ops.extend([OP_M] * r)
        v += r
        h += r
    for code in reversed(chain):
        op = code >> 1
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
        if code & 1:
            r = _lcp(p, t, v, h)
            ops.extend([OP_M] * r)
            v += r
            h += r
    if v != plen or h != tlen:
        raise TracebackError(
            f"replay consumed ({v}, {h}) of ({plen}, {tlen})",
            pair=pair, h=h, v=v)
    return np.asarray(ops, np.int8)


def _walk_packed(chain: list, m_bt, i_bt, d_bt, x: int, o: int, e: int,
                 score: int, plen: int, tlen: int, pair: Optional[int] = None,
                 begin_state: str = "M", end_state: str = "M") -> bool:
    """Phase A (gap-affine): walk provenance codes from the end cell to the
    origin, appending the *edit* chain (no match runs) back-to-front to
    ``chain`` -> ``extend_start``, False when a begin-state gap chain ended
    on its (codeless) seed cell."""
    kc = m_bt.shape[-1] // 2
    s, k, state = int(score), tlen - plen, end_state
    close = 0                                 # next gap op folds into M
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
                chain.append(_X_EXT)
                s -= x
            elif c == BT_M_FROM_I:
                state, close = "I", 1
            elif c == BT_M_FROM_D:
                state, close = "D", 1
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
            chain.append(OP_I << 1 | close)
            close = 0
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
            chain.append(OP_D << 1 | close)
            close = 0
            k += 1
            if c == BT_GAP_EXT:
                s -= e
            else:
                s -= o + e
                state = "M"
    else:
        raise TracebackError("packed traceback did not terminate",
                             pair=pair, s=s, k=k)
    return extend_start


def _walk_packed_linear(chain: list, m_bt, x: int, e: int, score: int,
                        plen: int, tlen: int,
                        pair: Optional[int] = None) -> bool:
    """Phase A (one matrix), appending to ``chain`` -> True: every op
    returns to an M cell, so forward replay re-extends matches after each
    one."""
    kc = m_bt.shape[-1] // 2
    s, k = int(score), tlen - plen
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
            chain.append(_X_EXT)
            s -= x
        elif c == BT_M_FROM_I:
            chain.append(OP_I << 1 | 1)
            s -= e
            k -= 1
        elif c == BT_M_FROM_D:
            chain.append(OP_D << 1 | 1)
            s -= e
            k += 1
        else:
            raise TracebackError("invalid M provenance code",
                                 pair=pair, s=s, k=k)
    else:
        raise TracebackError("packed traceback did not terminate",
                             pair=pair, s=s, k=k)
    return True


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
    alignment opens mid-gap).  The walk (:func:`_walk_packed`) and the
    replay (:func:`_replay`) composed.
    """
    if score < 0:
        return np.empty((0,), np.int8)
    pen = scoring.as_model(pen)
    chain: list[int] = []
    extend_start = _walk_packed(chain, m_bt, i_bt, d_bt, pen.x, pen.o,
                                pen.e, score, plen, tlen, pair=pair,
                                begin_state=begin_state, end_state=end_state)
    return _replay(chain, np.asarray(pattern)[:plen],
                   np.asarray(text)[:tlen], plen, tlen, pair=pair,
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
    chain: list[int] = []
    _walk_packed_linear(chain, m_bt, model.x, model.e, score, plen, tlen,
                        pair=pair)
    return _replay(chain, np.asarray(pattern)[:plen],
                   np.asarray(text)[:tlen], plen, tlen, pair=pair)


def traceback_packed_batch(result, pen, pattern, text, plen, tlen,
                           begin_state: str = "M", end_state: str = "M"):
    """-> list of per-pair op arrays (ragged) from packed provenance,
    dispatched on the model's recurrence kind.

    Every pair of the wave is walked first (one ``traceback.walk`` span),
    its chain appended to one flat list, then every chain is replayed (one
    ``traceback.replay`` span); both carry ``pairs`` and ``edits``, the
    chains' total length."""
    model = scoring.as_model(pen)
    m_bt = np.asarray(result.m_bt)
    scores = np.asarray(result.score).reshape(-1)
    pattern = np.asarray(pattern)
    text = np.asarray(text)
    plen = np.asarray(plen).reshape(-1)
    tlen = np.asarray(tlen).reshape(-1)
    n = scores.shape[0]
    if model.kind == "linear":
        if begin_state != "M" or end_state != "M":
            raise ValueError("linear models have no I/D boundary states")

        def walk(chain, b):
            return _walk_packed_linear(chain, m_bt[:, b], model.x, model.e,
                                       int(scores[b]), int(plen[b]),
                                       int(tlen[b]), pair=b)
    else:
        i_bt = np.asarray(result.i_bt)
        d_bt = np.asarray(result.d_bt)

        def walk(chain, b):
            return _walk_packed(chain, m_bt[:, b], i_bt[:, b], d_bt[:, b],
                                model.x, model.o, model.e, int(scores[b]),
                                int(plen[b]), int(tlen[b]), pair=b,
                                begin_state=begin_state, end_state=end_state)

    on = obs_trace.enabled()
    chains: list[int] = []            # every pair's chain, one after another
    starts = [0] * (n + 1)            # pair b's chain: chains[starts[b]:...]
    extend = [None] * n               # its extend_start; None: unresolved
    with obs_trace.span("traceback.walk", cat="wave") as sp:
        for b in range(n):
            if scores[b] >= 0:
                extend[b] = walk(chains, b)
            starts[b + 1] = len(chains)
        if on:
            sp.set(pairs=n, edits=len(chains))
    with obs_trace.span("traceback.replay", cat="wave",
                        args={"pairs": n, "edits": len(chains)}
                        if on else None):
        return [np.empty((0,), np.int8) if extend[b] is None else
                _replay(chains[starts[b]:starts[b + 1]], pattern[b, :plen[b]],
                        text[b, :tlen[b]], int(plen[b]), int(tlen[b]),
                        pair=b, extend_start=extend[b])
                for b in range(n)]


# ---------------------------------------------------------------------------
# Decoded ops: the packed trace walked and replayed where it lies.

# The error a decoded pair's status row names, by its code (row [code, s, k,
# h]): codes 1-7 are the walk's, at (s, k); 8-10 the replay's, at h; 11 the
# replay's end check, with the pattern offset v in the s slot.
TB_ERRORS = (None, "origin cell off diagonal 0", "invalid M provenance code",
             "I chain hit s=0 off the gap seed",
             "D chain hit s=0 off the gap seed", "invalid I provenance code",
             "invalid D provenance code", "packed traceback did not terminate",
             "mismatch op past sequence end", "insertion op past text end",
             "deletion op past pattern end", "replay consumed")
_TB_WALK_MAX = 7
_TB_CONSUMED = 11


def _status_row(err: TracebackError) -> tuple:
    if err.v is not None:
        return _TB_CONSUMED, err.v, 0, err.h
    code = TB_ERRORS.index(err.msg)
    if code <= _TB_WALK_MAX:
        return code, err.s, err.k, 0
    return code, 0, 0, err.h


def _status_error(pair: int, row, plen: int, tlen: int) -> TracebackError:
    """The :class:`TracebackError` a status row names."""
    code, s, k, h = (int(c) for c in row)
    if code == _TB_CONSUMED:
        return TracebackError(f"replay consumed ({s}, {h}) of ({plen}, "
                              f"{tlen})", pair=pair, h=h, v=s)
    if not 0 < code < len(TB_ERRORS):
        return TracebackError(f"unknown traceback status {code}", pair=pair)
    if code <= _TB_WALK_MAX:
        return TracebackError(TB_ERRORS[code], pair=pair, s=s, k=k)
    return TracebackError(TB_ERRORS[code], pair=pair, h=h)


def decode_packed_plain(result, pen, pattern, text, plen, tlen):
    """The decoded encoding of a packed trace, built on the host by the walk
    and the replay -> ``(ops [B, L] int8, n_ops [B] int32, status [B, 4]
    int32)``, ``L = pattern.shape[1] + text.shape[1]``.

    Row b holds pair b's ops padded with -1 (none where it is unresolved or
    fails), ``n_ops[b]`` their count, ``status[b]`` 0 or the error the walk
    or the replay raises for it (:data:`TB_ERRORS`).  A length past its row
    is clamped to the row, as the trace kernel does.  Boundary states are M
    to M.  What the CUDA traceback kernel returns, bit for bit."""
    model = scoring.as_model(pen)
    m_bt = np.asarray(result.m_bt)
    i_bt = d_bt = None
    if model.kind != "linear":
        i_bt, d_bt = np.asarray(result.i_bt), np.asarray(result.d_bt)
    scores = np.asarray(result.score).reshape(-1)
    pattern, text = np.asarray(pattern), np.asarray(text)
    plen = np.minimum(np.asarray(plen).reshape(-1), pattern.shape[1])
    tlen = np.minimum(np.asarray(tlen).reshape(-1), text.shape[1])
    n = scores.shape[0]
    ops = np.full((n, pattern.shape[1] + text.shape[1]), -1, np.int8)
    n_ops = np.zeros((n,), np.int32)
    status = np.zeros((n, 4), np.int32)
    for b in range(n):
        if scores[b] < 0:
            continue
        pl, tl, chain = int(plen[b]), int(tlen[b]), []
        try:
            if i_bt is None:
                ext = _walk_packed_linear(chain, m_bt[:, b], model.x, model.e,
                                          int(scores[b]), pl, tl, pair=b)
            else:
                ext = _walk_packed(chain, m_bt[:, b], i_bt[:, b], d_bt[:, b],
                                   model.x, model.o, model.e, int(scores[b]),
                                   pl, tl, pair=b)
            row = _replay(chain, pattern[b, :pl], text[b, :tl], pl, tl,
                          pair=b, extend_start=ext)
        except TracebackError as err:
            status[b] = _status_row(err)
            continue
        ops[b, :row.size] = row
        n_ops[b] = row.size
    return ops, n_ops, status


def traceback_decoded(result, plen, tlen) -> List[np.ndarray]:
    """Per-pair op arrays from the decoded encoding -> as
    :func:`traceback_packed_batch`: the first pair whose walk failed, else
    the first whose replay failed, raises its :class:`TracebackError`.

    The used bytes of every row are copied once, in row order, into one
    ordinary array, and each pair's ops are a slice of it: no array keeps
    the (pinned) result buffer or a padded row alive."""
    status = np.asarray(result.status).reshape(-1, 4)
    bad = np.flatnonzero(status[:, 0])
    if bad.size:
        walk = bad[status[bad, 0] <= _TB_WALK_MAX]
        b = int((walk if walk.size else bad)[0])
        raise _status_error(b, status[b], int(np.asarray(plen)[b]),
                            int(np.asarray(tlen)[b]))
    n = np.asarray(result.n_ops).reshape(-1).astype(np.int32)
    width = int(n.max()) if n.size else 0
    rows = np.asarray(result.ops)[:, :width]
    flat = rows[np.arange(width, dtype=np.int32)[None, :] < n[:, None]]
    ends = np.cumsum(n, dtype=np.int64)
    return [flat[a:e] for a, e in zip((ends - n).tolist(), ends.tolist())]


def traceback_result(result, pen, *, pattern, text, plen, tlen,
                     k_max: int, begin_state: str = "M",
                     end_state: str = "M"):
    """Dispatch on the trace encoding a ``WFAResult`` carries.

    Full offset history (``ref``) -> pointer-chase traceback; packed
    provenance words (``ring``/``shardmap``, ``kernel`` on the CPU) ->
    decode + replay; ops decoded on the card (``kernel``) -> each pair's
    ops cut out (:func:`traceback_decoded`).  ``pen`` may be a legacy
    ``Penalties`` triple or any ``PenaltyModel``; linear models decode
    their single M plane.  ``begin_state`` / ``end_state`` select BiWFA
    sub-alignment boundaries (affine only).
    """
    if getattr(result, "m_hist", None) is not None:
        return traceback_batch(result, pen, plen, tlen, k_max,
                               begin_state=begin_state, end_state=end_state)
    if getattr(result, "m_bt", None) is not None:
        return traceback_packed_batch(result, pen, pattern, text, plen,
                                      tlen, begin_state=begin_state,
                                      end_state=end_state)
    if getattr(result, "ops", None) is not None:
        if begin_state != "M" or end_state != "M":
            raise ValueError("decoded ops carry no boundary states")
        return traceback_decoded(result, plen, tlen)
    raise ValueError("result carries no trace (score-only backend output); "
                     "run the backend's trace variant (output='cigar')")


def trace_held_nbytes(result) -> int:
    """The trace memory the wave held on its device: the planes the card
    decoded into ``ops`` (``plane_nbytes``), else :func:`trace_nbytes`."""
    if getattr(result, "ops", None) is not None:
        return int(result.plane_nbytes)
    return trace_nbytes(result)


def trace_nbytes(result) -> int:
    """Host-visible bytes of whichever trace encoding ``result`` carries:
    what the wave's copy out brought back of it."""
    total = 0
    for f in ("m_hist", "i_hist", "d_hist", "m_bt", "i_bt", "d_bt", "ops",
              "n_ops", "status"):
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

"""Batched Wavefront Algorithm (WFA, Marco-Sola et al. 2021) on tensors.

The PyTorch counterpart of ``repro.core.wavefront``: a *batch* of pairs
advances in lock-step over score ``s``, with every buffer statically sized
from ``(s_max, k_max)``.  The solvers take numpy arrays or tensors and run
on ``device``: ``None`` means the card (``"cuda"``), which must exist
(:func:`resolve_device`); ``"cpu"`` runs them on the host.  They are the
plain ``ring`` backend and the oracle that the CUDA kernel
(``repro_torch.kernels.wfa``) is held against.

Conventions
-----------
pattern ``p`` (length ``n``, vertical axis), text ``t`` (length ``m``,
horizontal).  A wavefront cell on diagonal ``k = h - v`` stores the furthest
reaching *offset* ``h`` (text chars consumed) attainable with cost exactly
``s``; ``v = h - k`` is the pattern position.

The penalty model's ``kind`` selects the recurrence:

* ``"affine"`` (gap cost o + L*e) — the three-matrix scheme:

      I_s[k] = max(M_{s-o-e}[k-1], I_{s-e}[k-1]) + 1    (gap consuming text)
      D_s[k] = max(M_{s-o-e}[k+1], D_{s-e}[k+1])        (gap consuming pat)
      M_s[k] = max(M_{s-x}[k] + 1, I_s[k], D_s[k])      (mismatch/close gap)

* ``"linear"`` (gap cost L*e; includes ``Edit``) — one matrix:

      M_s[k] = max(M_{s-x}[k] + 1, M_{s-e}[k-1] + 1, M_{s-e}[k+1])

Both kinds share the extend step ``M_s[k] += LCP(t[h:], p[v:])`` and stop
at the first ``s`` with ``M_s[m-n] == m``.  Invalid cells hold ``NEG``.  A
wavefront heuristic (``heur=``) prunes k-lanes after each step
(:func:`keep_mask`).

Two modes are ported here (both over a ring of depth ``window``):

* :func:`wfa_scores` — score only;
* :func:`wfa_scores_packed` — plus 2-bit per-cell provenance codes packed
  16 steps to an int32 word (``[n_trace_words, B, K]``, three planes for
  affine models, one for linear), which ``core.cigar`` decodes.

Provenance code values (2 bits each, 0 = invalid/never-written):

    affine M cell: 1 = from mismatch, 2 = folded I_s[k], 3 = folded D_s[k]
    affine I/D cell: 1 = gap open, 2 = gap extend
    linear M cell: 1 = mismatch, 2 = insertion, 3 = deletion

The compacting band (``band_cap``), the full-history solver and the BiWFA
meet solver are not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import scoring
from repro_torch.core.scoring import AdaptiveBand, ZDrop

NEG = -(1 << 20)  # invalid-cell sentinel; survives +1 arithmetic harmlessly
_VALID_THRESH = NEG // 2
_BIG = 1 << 20

# Packed-backtrace provenance codes (2 bits per cell; 0 = invalid).
BT_NONE = 0
BT_M_FROM_X, BT_M_FROM_I, BT_M_FROM_D = 1, 2, 3   # M-cell origins
BT_GAP_OPEN, BT_GAP_EXT = 1, 2                     # I/D-cell origins
TRACE_CELLS_PER_WORD = 16                          # 2-bit cells in an int32

STATES = ("M", "I", "D")


def n_trace_words(s_max: int) -> int:
    """int32 words along the packed score axis covering s in [0, s_max]."""
    return (int(s_max) + TRACE_CELLS_PER_WORD) // TRACE_CELLS_PER_WORD


class WFAResult(NamedTuple):
    score: torch.Tensor                 # [B] int32 cost, -1 if > s_max
    m_hist: Optional[torch.Tensor]      # full history: not ported (None)
    i_hist: Optional[torch.Tensor]
    d_hist: Optional[torch.Tensor]
    n_steps: int                        # score-loop trips (telemetry)
    m_bt: Optional[torch.Tensor] = None  # [n_trace_words, B, K] packed codes
    i_bt: Optional[torch.Tensor] = None  # None in score mode / linear models
    d_bt: Optional[torch.Tensor] = None


def _check_states(model, begin_state: str, end_state: str) -> None:
    if begin_state not in STATES or end_state not in STATES:
        raise ValueError(f"boundary states must be one of {STATES}; got "
                         f"({begin_state!r}, {end_state!r})")
    if model.kind != "affine" and (begin_state != "M" or end_state != "M"):
        raise ValueError(
            "gap-linear/edit models have no I/D states; boundary-state "
            "sub-alignments need a gap-affine penalty model")


def _resolve(pen, heur):
    return scoring.as_model(pen), scoring.as_heuristic(heur)


def resolve_device(device=None) -> torch.device:
    """The device the port runs on: ``None`` means the card, which must
    exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev


def _prep(pattern, text, plen, tlen, device=None):
    """int32 tensors on :func:`resolve_device` of ``device``."""
    dev = resolve_device(device)
    as_i32 = lambda a: torch.as_tensor(a, device=dev).to(torch.int32)
    return (as_i32(pattern), as_i32(text), as_i32(plen).reshape(-1),
            as_i32(tlen).reshape(-1))


def _shift_from_km1(w):
    """w[..., k] <- w[..., k-1]  (diagonal k reads its left neighbour)."""
    return torch.nn.functional.pad(w[..., :-1], (1, 0), value=NEG)


def _shift_from_kp1(w):
    """w[..., k] <- w[..., k+1]."""
    return torch.nn.functional.pad(w[..., 1:], (0, 1), value=NEG)


def _gather_cols(seq, idx):
    """seq[b, clip(idx[b, k])] as [B, K] (out-of-range lanes read junk that
    the caller's validity mask discards)."""
    return torch.gather(seq, 1, idx.clamp(0, seq.shape[1] - 1).long())


def _extend(M, pattern, text, plen, tlen, ks):
    """Greedy diagonal extension, all (pair, diagonal) lanes in lock-step:
    one matched character per trip until no lane advances."""
    if pattern.shape[1] == 0 or text.shape[1] == 0:
        return M
    ks2 = ks if ks.dim() == 2 else ks[None, :]
    pl = plen[:, None]
    tl = tlen[:, None]
    while True:
        v = M - ks2
        can = ((M > _VALID_THRESH) & (M >= 0) & (M < tl)
               & (v >= 0) & (v < pl))
        adv = can & (_gather_cols(text, M) == _gather_cols(pattern, v))
        if not bool(adv.any()):
            return M
        M = M + adv.to(M.dtype)


def keep_mask(heur, M, plen, tlen, ks):
    """[B, K] bool: lanes the heuristic keeps live after this score step.

    ``M`` is the post-extend M wavefront; ``plen``/``tlen`` are ``[B, 1]``
    and ``ks`` ``[1, K]`` or ``[B, K]``.  Exact heuristics keep every lane
    (None); :class:`AdaptiveBand` prunes lanes whose remaining-distance
    estimate ``max(m - h, n - v)`` exceeds the front's best by more than
    ``max_distance_diff`` once more than ``min_wf_len`` lanes are live;
    :class:`ZDrop` prunes lanes whose antidiagonal progress ``h + v``
    trails the front's best by more than ``zdrop``.
    """
    if heur.exact:
        return None
    valid = M > _VALID_THRESH
    h = M
    v = M - ks
    if isinstance(heur, AdaptiveBand):
        d = torch.where(valid, torch.maximum(tlen - h, plen - v), _BIG)
        d_min = d.amin(dim=-1, keepdim=True)
        n_live = valid.sum(dim=-1, keepdim=True)
        return valid & ((n_live <= heur.min_wf_len)
                        | (d - d_min <= heur.max_distance_diff))
    if isinstance(heur, ZDrop):
        a = torch.where(valid, h + v, -_BIG)
        best = a.amax(dim=-1, keepdim=True)
        return valid & (best - a <= heur.zdrop)
    raise TypeError(f"unknown heuristic {heur!r}")


def _pruned(keep, *fronts):
    """Apply a keep mask to each non-None wavefront (None mask = exact)."""
    if keep is None:
        return fronts if len(fronts) > 1 else fronts[0]
    out = tuple(w if w is None else torch.where(keep, w, NEG)
                for w in fronts)
    return out if len(out) > 1 else out[0]


def _prune_step(heur, plen, tlen, ks, *fronts):
    """Mask from M (``fronts[0]``), applied to every front."""
    keep = keep_mask(heur, fronts[0], plen[:, None], tlen[:, None],
                     ks[None, :])
    return _pruned(keep, *fronts)


def _m_code(M_pre, X_new, I_new):
    return torch.where(
        M_pre > _VALID_THRESH,
        torch.where(M_pre == X_new, BT_M_FROM_X,
                    torch.where(M_pre == I_new, BT_M_FROM_I, BT_M_FROM_D)),
        BT_NONE).to(torch.int32)


def _gap_code(new, ext, opn):
    return torch.where(new > _VALID_THRESH,
                       torch.where(ext >= opn, BT_GAP_EXT, BT_GAP_OPEN),
                       BT_NONE).to(torch.int32)


def _candidates(m_x, i_src, d_src, plen, tlen, ks):
    """(X_new, I_new, D_new): the step's three bounded candidates."""
    tl = tlen[:, None]
    pl = plen[:, None]
    ks2 = ks if ks.dim() == 2 else ks[None, :]
    I_new = torch.where((i_src > _VALID_THRESH) & (i_src + 1 <= tl),
                        i_src + 1, NEG)
    D_new = torch.where((d_src > _VALID_THRESH) & (d_src - ks2 <= pl),
                        d_src, NEG)
    X_new = torch.where((m_x > _VALID_THRESH) & (m_x + 1 <= tl)
                        & (m_x + 1 - ks2 <= pl), m_x + 1, NEG)
    return X_new, I_new, D_new


def _next_affine(model, read_m, pattern, text, plen, tlen, ks,
                 read_i, read_d, with_codes=False):
    """One gap-affine step: (M_s, I_s, D_s) from history accessors.

    ``read_m/read_i/read_d(delta)`` return the wavefront at score
    ``s - delta`` (NEG-filled when s - delta < 0).  With ``with_codes`` also
    returns the provenance code planes ``(code_m, code_i, code_d)``.
    """
    x, o, e = model.x, model.o, model.e
    m_owe = read_m(o + e)
    m_x = read_m(x)
    i_open = _shift_from_km1(m_owe)
    i_ext = _shift_from_km1(read_i(e))
    d_open = _shift_from_kp1(m_owe)
    d_ext = _shift_from_kp1(read_d(e))
    X_new, I_new, D_new = _candidates(m_x, torch.maximum(i_open, i_ext),
                                      torch.maximum(d_open, d_ext),
                                      plen, tlen, ks)
    M_pre = torch.maximum(torch.maximum(X_new, I_new), D_new)
    M_new = _extend(M_pre, pattern, text, plen, tlen, ks)
    if not with_codes:
        return M_new, I_new, D_new
    # tie-break X, then I, then D; extend over open (as the decoder expects)
    return (M_new, I_new, D_new, _m_code(M_pre, X_new, I_new),
            _gap_code(I_new, i_ext, i_open), _gap_code(D_new, d_ext, d_open))


def _next_linear(model, read_m, pattern, text, plen, tlen, ks,
                 with_codes=False):
    """One gap-linear step: M_s from the single M-history accessor (with
    ``with_codes`` also the M provenance plane)."""
    x, e = model.x, model.e
    m_x = read_m(x)
    m_e = m_x if x == e else read_m(e)
    X_new, I_new, D_new = _candidates(m_x, _shift_from_km1(m_e),
                                      _shift_from_kp1(m_e), plen, tlen, ks)
    M_pre = torch.maximum(torch.maximum(X_new, I_new), D_new)
    M_new = _extend(M_pre, pattern, text, plen, tlen, ks)
    if not with_codes:
        return M_new
    return M_new, _m_code(M_pre, X_new, I_new)


def _target_reached(M, plen, tlen, k_max):
    """[B] bool: does M hold offset == tlen on the final diagonal?"""
    k_final = tlen - plen + k_max
    K = M.shape[-1]
    in_band = (k_final >= 0) & (k_final < K)
    idx = k_final.clamp(0, K - 1).long()
    val = torch.gather(M, 1, idx[:, None])[:, 0]
    return in_band & (val >= tlen) & (val > _VALID_THRESH)


def _ring_reader(ring, s, W):
    def read(delta):
        if s < delta:
            return torch.full_like(ring[0], NEG)
        return ring[(s - delta) % W]
    return read


def _pack(bt, s, code):
    """OR the [B, K] code plane into word s//16 at bit offset 2*(s%16)."""
    sh = 2 * (s % TRACE_CELLS_PER_WORD)
    bt[s // TRACE_CELLS_PER_WORD] |= torch.bitwise_left_shift(code, sh)


def _solve(pattern, text, plen, tlen, pen, s_max, k_max, heur, band_cap,
           packed, begin_state="M", end_state="M",
           device=None) -> WFAResult:
    """Shared ring solver behind :func:`wfa_scores` (score only) and
    :func:`wfa_scores_packed` (plus the packed backtrace)."""
    model, heur = _resolve(pen, heur)
    _check_states(model, begin_state, end_state)
    if band_cap is not None:
        raise NotImplementedError(
            "the compacting band (band_cap) is not ported yet")
    pattern, text, plen, tlen = _prep(pattern, text, plen, tlen, device)
    dev = pattern.device
    B = pattern.shape[0]
    K = 2 * k_max + 1
    W = model.window
    affine = model.kind == "affine"
    ks = torch.arange(K, dtype=torch.int32, device=dev) - k_max
    new = lambda *shape: torch.full(shape, NEG, dtype=torch.int32,
                                    device=dev)

    seed = new(B, K)
    seed[:, k_max] = 0
    M0 = _extend(seed, pattern, text, plen, tlen, ks)
    m_ring = new(W, B, K)
    m_ring[0] = M0
    front0 = M0
    if affine:
        i_ring = new(W, B, K)
        d_ring = new(W, B, K)
        if begin_state == "I":
            i_ring[0] = seed
        if begin_state == "D":
            d_ring[0] = seed
        front0 = {"M": M0, "I": i_ring[0], "D": d_ring[0]}[end_state]
    score = torch.where(_target_reached(front0, plen, tlen, k_max), 0,
                        -1).to(torch.int32)
    bts = ()
    if packed:
        NW = n_trace_words(s_max)
        bts = tuple(torch.zeros((NW, B, K), dtype=torch.int32, device=dev)
                    for _ in range(3 if affine else 1))

    s = 1
    while s <= s_max and bool((score < 0).any()):
        if affine:
            out = _next_affine(model, _ring_reader(m_ring, s, W), pattern,
                               text, plen, tlen, ks,
                               _ring_reader(i_ring, s, W),
                               _ring_reader(d_ring, s, W),
                               with_codes=packed)
            M_new, I_new, D_new = out[:3]
            end = {"M": M_new, "I": I_new, "D": D_new}[end_state]
            codes = out[3:]
        else:
            out = _next_linear(model, _ring_reader(m_ring, s, W), pattern,
                               text, plen, tlen, ks, with_codes=packed)
            M_new, codes = (out[0], out[1:]) if packed else (out, ())
            end = M_new
        reached = _target_reached(end, plen, tlen, k_max)
        score = torch.where((score < 0) & reached, s, score).to(torch.int32)
        row = s % W
        if affine:
            M_new, I_new, D_new = _prune_step(heur, plen, tlen, ks,
                                              M_new, I_new, D_new)
            i_ring[row] = I_new
            d_ring[row] = D_new
        else:
            M_new = _prune_step(heur, plen, tlen, ks, M_new)
        m_ring[row] = M_new
        for bt, code in zip(bts, codes):
            _pack(bt, s, code)
        s += 1
    bts = bts + (None,) * (3 - len(bts)) if packed else (None,) * 3
    return WFAResult(score, None, None, None, s, *bts)


def wfa_scores(pattern, text, plen, tlen, *, pen, s_max: int, k_max: int,
               heur=None, band_cap=None, device=None) -> WFAResult:
    """Ring-buffer batched WFA — score-only throughput mode.

    Rings of ``[window, B, K]`` (3 for affine, 1 for linear) with
    ``window = max(x, o+e) + 1``; the whole batch stops at the first step
    where every pair has reached its target (or at ``s_max``).
    """
    return _solve(pattern, text, plen, tlen, pen, s_max, k_max, heur,
                  band_cap, packed=False, device=device)


def wfa_scores_packed(pattern, text, plen, tlen, *, pen, s_max: int,
                      k_max: int, heur=None, begin_state: str = "M",
                      end_state: str = "M", band_cap=None,
                      device=None) -> WFAResult:
    """Ring-buffer batched WFA *with* a packed backtrace: ``[n_trace_words,
    B, K]`` int32 arrays of 2-bit provenance codes (three planes for affine
    models, one for linear) that ``core.cigar`` decodes into exact CIGARs.

    ``begin_state``/``end_state`` (affine only) seed an already-open gap at
    the origin / end the alignment inside a gap run.
    """
    return _solve(pattern, text, plen, tlen, pen, s_max, k_max, heur,
                  band_cap, packed=True, begin_state=begin_state,
                  end_state=end_state, device=device)

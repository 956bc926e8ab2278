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

Three modes:

* :func:`wfa_forward` — the full ``[s_max+1, B, K]`` offset history (M/I/D
  for affine models, M only for linear ones), which ``core.cigar`` chases
  pointer by pointer (the ``ref`` backend);
* :func:`wfa_scores` — score only, over a ring of depth ``window``;
* :func:`wfa_scores_packed` — the ring plus 2-bit per-cell provenance
  codes packed 16 steps to an int32 word (``[n_trace_words, B, K]``, three
  planes for affine models, one for linear), which ``core.cigar`` decodes.

Provenance code values (2 bits each, 0 = invalid/never-written):

    affine M cell: 1 = from mismatch, 2 = folded I_s[k], 3 = folded D_s[k]
    affine I/D cell: 1 = gap open, 2 = gap extend
    linear M cell: 1 = mismatch, 2 = insertion, 3 = deletion

:func:`wfa_bidir_meet` is the BiWFA meet-in-the-middle breakpoint solver
(forward and reverse fronts over rolling windows); it serves backends
without a meet variant and is the oracle of the CUDA meet kernel.

Both ring solvers take ``band_cap``: the *compacting band* carries the
fronts at a compact width ``Kc`` in a per-pair window that re-centres on the
live diagonals each step (:func:`_scores_band`); the packed planes stay full
width.

:func:`wfa_scores_shardmap` and :func:`wfa_trace_shardmap` serve the
``shardmap`` backend: the pair axis splits into one contiguous slice per
device of a mesh (``repro_torch.launch.mesh``), and each slice runs the ring
solver on its own device to its own termination, with no state shared.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, NamedTuple, Optional

import torch

from repro_torch.core import scoring
from repro_torch.core.scoring import AdaptiveBand, ZDrop
from repro_torch.device import resolve_device

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
    m_hist: Optional[torch.Tensor]      # [s_max+1, B, K] (wfa_forward) or None
    i_hist: Optional[torch.Tensor]      # None for linear models
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


_EXT_CHUNK = 8   # characters each valid lane compares on its first trip


def _extend(M, pattern, text, plen, tlen, ks):
    """Greedy diagonal extension ``M += LCP(t[h:], p[v:])`` on every valid
    lane.

    Each trip compares a chunk of characters per lane and advances the lane
    by its matched prefix.  Only lanes that matched the whole chunk take
    another trip, gathered into a compact list, with the chunk doubled, so
    a long match run costs a few trips and a short one a single trip.  The
    result equals one character per trip (the reference's loop)."""
    if pattern.shape[1] == 0 or text.shape[1] == 0:
        return M
    B, K = M.shape
    ks2 = (ks if ks.dim() == 2 else ks[None, :]).expand(B, K)
    b, j = torch.nonzero(M > _VALID_THRESH, as_tuple=True)
    if b.numel() == 0:
        return M
    out = M.clone()
    h, k = M[b, j], ks2[b, j]
    pl, tl = plen[b, None], tlen[b, None]
    Lp, Lt = pattern.shape[1], text.shape[1]
    chunk = _EXT_CHUNK
    while True:
        hh = h[:, None] + torch.arange(chunk, dtype=h.dtype, device=h.device)
        vv = hh - k[:, None]
        ok = (hh >= 0) & (hh < tl) & (vv >= 0) & (vv < pl)
        eq = ok & (text[b[:, None], hh.clamp(0, Lt - 1).long()]
                   == pattern[b[:, None], vv.clamp(0, Lp - 1).long()])
        run = eq.to(torch.int32).cumprod(dim=1).sum(dim=1).to(h.dtype)
        h = h + run
        out[b, j] = h
        full = run == chunk
        if not bool(full.any()):
            return out
        b, j, h, k, pl, tl = (t[full] for t in (b, j, h, k, pl, tl))
        chunk *= 2


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
                 read_i, read_d, with_codes=False, with_pre=False):
    """One gap-affine step: (M_s, I_s, D_s) from history accessors.

    ``read_m/read_i/read_d(delta)`` return the wavefront at score
    ``s - delta`` (NEG-filled when s - delta < 0).  With ``with_codes`` also
    returns the provenance code planes ``(code_m, code_i, code_d)``; with
    ``with_pre`` the pre-extension M instead (the meet's split safety).
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
    if with_pre:
        return M_new, I_new, D_new, M_pre
    if not with_codes:
        return M_new, I_new, D_new
    # tie-break X, then I, then D; extend over open (as the decoder expects)
    return (M_new, I_new, D_new, _m_code(M_pre, X_new, I_new),
            _gap_code(I_new, i_ext, i_open), _gap_code(D_new, d_ext, d_open))


def _next_linear(model, read_m, pattern, text, plen, tlen, ks,
                 with_codes=False, with_pre=False):
    """One gap-linear step: M_s from the single M-history accessor (with
    ``with_codes`` also the M provenance plane, with ``with_pre`` the
    pre-extension M)."""
    x, e = model.x, model.e
    m_x = read_m(x)
    m_e = m_x if x == e else read_m(e)
    X_new, I_new, D_new = _candidates(m_x, _shift_from_km1(m_e),
                                      _shift_from_kp1(m_e), plen, tlen, ks)
    M_pre = torch.maximum(torch.maximum(X_new, I_new), D_new)
    M_new = _extend(M_pre, pattern, text, plen, tlen, ks)
    if with_pre:
        return M_new, M_pre
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


# ---------------------------------------------------------------------------
# Compacting band (WFA-adaptive style).
#
# Under a pruning heuristic only a bounded span of diagonals stays live, so
# the solvers can carry the fronts at a compact width Kc and slide a window
# along the diagonal axis: each ring row stores, besides its Kc offsets, the
# absolute K-index of its lane 0 (``off``, one per pair).  Each step the
# window re-centres on the live span of the previous row (M|I|D), reads of
# older rows realign by the offset delta, the target test and the ks plane
# shift by ``off``, and (packed mode) codes scatter back to absolute k
# before packing, so ``core.cigar`` decodes them unchanged.  Lanes outside
# the window are pruned as if the heuristic had killed them: when the live
# span fits Kc the results equal the full-width solver's.
# ---------------------------------------------------------------------------


def _band_recenter(valid, prev_off, Kc, K):
    """New window offset [B] centred on the live compact lanes ``valid``
    [B, Kc]; the previous offset where nothing is live."""
    jidx = torch.arange(Kc, dtype=torch.int32, device=valid.device)[None, :]
    lo = torch.where(valid, jidx, Kc).amin(dim=1)
    hi = torch.where(valid, jidx, -1).amax(dim=1)
    off = (prev_off + torch.div(lo + hi, 2, rounding_mode="floor")
           - Kc // 2).clamp(0, K - Kc)
    return torch.where(hi >= lo, off, prev_off).to(torch.int32)


def _band_read(ring, off_hist, s, delta, off, W):
    """Ring row at score ``s - delta`` realigned to the window offsets
    ``off`` [B] (NEG where the old row held no lane)."""
    if s < delta:
        return torch.full_like(ring[0], NEG)
    row = (s - delta) % W
    Kc = ring.shape[-1]
    jidx = torch.arange(Kc, dtype=torch.int32, device=ring.device)[None, :]
    idx = jidx + (off - off_hist[row])[:, None]
    ok = (idx >= 0) & (idx < Kc)
    return torch.where(ok, torch.gather(ring[row], 1,
                                        idx.clamp(0, Kc - 1).long()), NEG)


def _band_reached(M, plen, tlen, k_max, off):
    """[B] bool: target diagonal reached, at compact index ``k_final -
    off``."""
    return _target_reached(M, plen, tlen, k_max - off)


def _band_scatter(code, off, K):
    """Spread a compact [B, Kc] code plane to absolute width [B, K] (every
    window lies inside ``[0, K)``)."""
    Kc = code.shape[-1]
    idx = off[:, None].long() + torch.arange(Kc, device=code.device)
    return torch.zeros((code.shape[0], K), dtype=code.dtype,
                       device=code.device).scatter_(1, idx, code)


def _scores_band(pattern, text, plen, tlen, model, heur, s_max, k_max, Kc,
                 packed, begin_state, end_state) -> WFAResult:
    """Compacting-band ring solver (score only or packed backtrace) behind
    ``band_cap=`` of :func:`wfa_scores` / :func:`wfa_scores_packed`; the
    window discipline is the block comment's.  The packed planes stay
    ``[n_trace_words, B, K]``."""
    dev = pattern.device
    B = pattern.shape[0]
    K = 2 * k_max + 1
    W = model.window
    affine = model.kind == "affine"
    off0s = min(max(k_max - Kc // 2, 0), K - Kc)
    jidx = torch.arange(Kc, dtype=torch.int32, device=dev)[None, :]
    ks_of = lambda off: off[:, None] + jidx - k_max
    new = lambda *shape: torch.full(shape, NEG, dtype=torch.int32,
                                    device=dev)

    off = torch.full((B,), off0s, dtype=torch.int32, device=dev)
    seed = new(B, Kc)
    seed[:, k_max - off0s] = 0
    M0 = _extend(seed, pattern, text, plen, tlen, ks_of(off))
    m_ring = new(W, B, Kc)
    m_ring[0] = M0
    off_hist = torch.full((W, B), off0s, dtype=torch.int32, device=dev)
    front0 = M0
    if affine:
        i_ring, d_ring = new(W, B, Kc), new(W, B, Kc)
        if begin_state == "I":
            i_ring[0] = seed
        if begin_state == "D":
            d_ring[0] = seed
        front0 = {"M": M0, "I": i_ring[0], "D": d_ring[0]}[end_state]
    score = torch.where(_band_reached(front0, plen, tlen, k_max, off), 0,
                        -1).to(torch.int32)
    bts = ()
    if packed:
        NW = n_trace_words(s_max)
        bts = tuple(torch.zeros((NW, B, K), dtype=torch.int32, device=dev)
                    for _ in range(3 if affine else 1))

    s = 1
    while s <= s_max and bool((score < 0).any()):
        prow = (s - 1) % W
        live = m_ring[prow] > _VALID_THRESH
        if affine:
            # I/D fronts can outrun M between prunes: centre on the union
            live = (live | (i_ring[prow] > _VALID_THRESH)
                    | (d_ring[prow] > _VALID_THRESH))
        off = _band_recenter(live, off_hist[prow], Kc, K)
        ks = ks_of(off)
        rd = lambda ring: (lambda d: _band_read(ring, off_hist, s, d, off, W))
        if affine:
            out = _next_affine(model, rd(m_ring), pattern, text, plen, tlen,
                               ks, rd(i_ring), rd(d_ring), with_codes=packed)
            M_new, I_new, D_new = out[:3]
            end = {"M": M_new, "I": I_new, "D": D_new}[end_state]
            codes = out[3:]
        else:
            out = _next_linear(model, rd(m_ring), pattern, text, plen, tlen,
                               ks, with_codes=packed)
            M_new, codes = (out[0], out[1:]) if packed else (out, ())
            end = M_new
        reached = _band_reached(end, plen, tlen, k_max, off)
        score = torch.where((score < 0) & reached, s, score).to(torch.int32)
        keep = keep_mask(heur, M_new, plen[:, None], tlen[:, None], ks)
        row = s % W
        if affine:
            M_new, I_new, D_new = _pruned(keep, M_new, I_new, D_new)
            i_ring[row] = I_new
            d_ring[row] = D_new
        else:
            M_new = _pruned(keep, M_new)
        m_ring[row] = M_new
        off_hist[row] = off
        for bt, code in zip(bts, codes):
            _pack(bt, s, _band_scatter(code, off, K))
        s += 1
    bts = bts + (None,) * (3 - len(bts)) if packed else (None,) * 3
    return WFAResult(score, None, None, None, s, *bts)


def _band_width(band_cap, K):
    """Validated compact width, or None to run full width."""
    if band_cap is None:
        return None
    Kc = max(int(band_cap), 9)     # floor keeps shifts and seed well-defined
    return Kc if Kc < K else None


def _solve(pattern, text, plen, tlen, pen, s_max, k_max, heur, band_cap,
           packed, begin_state="M", end_state="M",
           device=None) -> WFAResult:
    """Shared ring solver behind :func:`wfa_scores` (score only) and
    :func:`wfa_scores_packed` (plus the packed backtrace); ``band_cap``
    below ``K`` runs the compacting band."""
    model, heur = _resolve(pen, heur)
    _check_states(model, begin_state, end_state)
    pattern, text, plen, tlen = _prep(pattern, text, plen, tlen, device)
    dev = pattern.device
    B = pattern.shape[0]
    K = 2 * k_max + 1
    Kc = _band_width(band_cap, K)
    if Kc is not None:
        return _scores_band(pattern, text, plen, tlen, model, heur, s_max,
                            k_max, Kc, packed, begin_state, end_state)
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


def wfa_forward(pattern, text, plen, tlen, *, pen, s_max: int, k_max: int,
                keep_history: bool = True, heur=None, begin_state: str = "M",
                end_state: str = "M", device=None) -> WFAResult:
    """Full-history batched WFA.

    pattern/text: ``[B, Lp]``/``[B, Lt]`` integer codes (padding never
    read).  Returns each pair's cost and, with ``keep_history``, the
    ``[s_max+1, B, K]`` offset history for traceback (M/I/D for affine
    models, M only for linear ones; rows past the last step stay ``NEG``).
    Without it only the ``window`` newest rows are kept while the loop runs
    and the histories come back ``None``.

    ``begin_state``/``end_state`` (affine only) seed an already-open gap at
    the origin / end the alignment inside a gap run (BiWFA sub-alignments).
    """
    model, heur = _resolve(pen, heur)
    _check_states(model, begin_state, end_state)
    pattern, text, plen, tlen = _prep(pattern, text, plen, tlen, device)
    dev = pattern.device
    B = pattern.shape[0]
    K = 2 * k_max + 1
    W = model.window
    affine = model.kind == "affine"
    ks = torch.arange(K, dtype=torch.int32, device=dev) - k_max
    new = lambda *shape: torch.full(shape, NEG, dtype=torch.int32,
                                    device=dev)

    # one buffer per front: the whole history, or a ring of the ``W``
    # newest rows (step s lives in row s % depth)
    depth = s_max + 1 if keep_history else W
    fronts = [new(depth, B, K) for _ in range(3 if affine else 1)]

    # s = 0: M_0[k=0] = LCP(p, t); I/D invalid unless an open gap is
    # inherited from the caller (begin-state seeding)
    seed = new(B, K)
    seed[:, k_max] = 0
    fronts[0][0] = _extend(seed, pattern, text, plen, tlen, ks)
    if affine and begin_state != "M":
        fronts["MID".index(begin_state)][0] = seed
    end = "MID".index(end_state)
    score = torch.where(_target_reached(fronts[end][0], plen, tlen, k_max),
                        0, -1).to(torch.int32)
    neg = new(B, K)

    def reader(rows, s):
        return lambda delta: rows[(s - delta) % depth] if s >= delta else neg

    s = 1
    while s <= s_max and bool((score < 0).any()):
        if affine:
            out = _next_affine(model, reader(fronts[0], s), pattern, text,
                               plen, tlen, ks, reader(fronts[1], s),
                               reader(fronts[2], s))
        else:
            out = (_next_linear(model, reader(fronts[0], s), pattern, text,
                                plen, tlen, ks),)
        reached = _target_reached(out[end], plen, tlen, k_max)
        score = torch.where((score < 0) & reached, s, score).to(torch.int32)
        out = _prune_step(heur, plen, tlen, ks, *out)
        for rows, row in zip(fronts, out if affine else (out,)):
            rows[s % depth] = row
        s += 1
    if not keep_history:
        return WFAResult(score, None, None, None, s)
    return WFAResult(score, *fronts, *[None] * (3 - len(fronts)), s)


def wfa_scores(pattern, text, plen, tlen, *, pen, s_max: int, k_max: int,
               heur=None, band_cap=None, device=None) -> WFAResult:
    """Ring-buffer batched WFA — score-only throughput mode.

    Rings of ``[window, B, K]`` (3 for affine, 1 for linear) with
    ``window = max(x, o+e) + 1``; the whole batch stops at the first step
    where every pair has reached its target (or at ``s_max``).

    ``band_cap`` switches on the compacting band: the fronts are carried at
    width ``max(band_cap, 9)`` (full width when that is not below ``K``) in
    a per-pair window that re-centres on the live diagonals each step.  It
    equals full width whenever the live span fits the window; otherwise the
    truncation is extra heuristic pruning, so pass it with a non-exact
    ``heur``.
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
    the origin / end the alignment inside a gap run.  ``band_cap`` as in
    :func:`wfa_scores`; the planes stay full width (codes scatter to
    absolute k), so ``core.cigar`` decodes band traces unchanged.
    """
    return _solve(pattern, text, plen, tlen, pen, s_max, k_max, heur,
                  band_cap, packed=True, begin_state=begin_state,
                  end_state=end_state, device=device)


class BidirMeetResult(NamedTuple):
    """Per-pair breakpoint from the meet-in-the-middle solver.

    ``score`` mirrors :class:`WFAResult` (``starget`` where a breakpoint
    was found, ``-1`` where the fronts never joined).
    """
    score: torch.Tensor       # [B] int32: starget if met, -1 if not
    n_steps: object           # lockstep trips taken (an int, or a 0-d
                              # tensor from the kernel: no host sync)
    meet_state: torch.Tensor  # [B] 0 = M/M, 1 = I/I, 2 = D/D; -1 unmet
    meet_a: torch.Tensor      # [B] prefix-side cost at the breakpoint
    meet_b: torch.Tensor      # [B] detector-internal reverse-side cost (gap
                              #     joins re-charge the open; end-state I/D
                              #     shifts by -o): the suffix child's cost
                              #     is starget - meet_a
    meet_k: torch.Tensor      # [B] forward diagonal k = h - v
    meet_h: torch.Tensor      # [B] text offset h of the breakpoint
    meet_safe: torch.Tensor   # [B] 1 = provably cost-exact split, 0 =
                              #     accepted opportunistically (the BiWFA
                              #     driver re-scores every stitched CIGAR)


def _reverse_rows(codes, lens):
    """Per-row suffix reversal: out[b, i] = codes[b, lens[b]-1-i], 0-padded
    (every solver masks reads beyond plen/tlen)."""
    L = codes.shape[1]
    idx = (lens.reshape(-1, 1).to(torch.int32) - 1
           - torch.arange(L, dtype=torch.int32, device=codes.device))
    g = torch.gather(codes, 1, idx.clamp(0, max(L - 1, 0)).long())
    return torch.where(idx >= 0, g, torch.zeros_like(g))


def meet_window(model) -> int:
    """Ring depth of the meet search, ``Wd = max(window, 2*maxop + 2)``: a
    split within ``maxop`` of the half-cost point is always examined."""
    maxop = max(model.x, model.o + model.e) if model.kind == "affine" \
        else max(model.x, model.e)
    return max(model.window, 2 * maxop + 2)


def _meet_lockstep(model, heur, pattern, text, pat_rev, txt_rev, plen, tlen,
                   starget, *, s_max: int, K: int, kc: int, begin_state: str,
                   end_state: str, met0, block_pairs: int):
    """Forward and reverse fronts in lockstep plus the meet test.

    Shared by :func:`wfa_bidir_meet` (one block: the whole batch, ``K =
    2*k_max+1``) and the meet kernel's plain version (blocks of
    ``block_pairs`` with ``K = k_pad``).  ``plen``/``tlen``/``starget``/
    ``met0`` are ``[B]``; pairs in ``met0`` start met.  A pair's fields
    change only at the step it meets, so a block that has exited (all met)
    is frozen.  -> (met, state, a, b, k, h, safe, steps [n_blocks], s).
    """
    dev = pattern.device
    B = pattern.shape[0]
    affine = model.kind == "affine"
    o = model.o if affine else 0
    # end_state I/D: the reverse rings seed the trailing gap run at 0 (it
    # is the reversed problem's leading gap), so every reverse cost sits o
    # below the forward-convention suffix cost; shift the target once
    oend = o if end_state != "M" else 0
    Wd = meet_window(model)
    ks = torch.arange(K, dtype=torch.int32, device=dev) - kc
    new = lambda *shape: torch.full(shape, NEG, dtype=torch.int32,
                                    device=dev)
    seed = new(B, K)
    seed[:, kc] = 0

    def ring0(row0):
        ring = new(Wd, B, K)
        ring[0] = row0
        return ring

    fm = ring0(_extend(seed, pattern, text, plen, tlen, ks))
    fmp = ring0(seed)
    rm = ring0(_extend(seed, pat_rev, txt_rev, plen, tlen, ks))
    if affine:
        fi = ring0(seed if begin_state == "I" else new(B, K))
        fd = ring0(seed if begin_state == "D" else new(B, K))
        ri = ring0(seed if end_state == "I" else new(B, K))
        rd = ring0(seed if end_state == "D" else new(B, K))

    # complement diagonal: the reverse lane addressing the same cell
    jj = torch.arange(K, dtype=torch.int32, device=dev)[None, :]
    jprime = (tlen - plen)[:, None] + 2 * kc - jj
    jpok = (jprime >= 0) & (jprime < K)
    jpc = jprime.clamp(0, K - 1).long()

    def comp(arr):
        return torch.where(jpok, torch.gather(arr, 1, jpc), NEG)

    m2 = tlen[:, None]
    low = ks.clamp(min=0)[None, :]
    bidx = torch.arange(B, device=dev)
    z = torch.zeros(B, dtype=torch.int32, device=dev)
    met = met0.clone()
    jst, ja, jb, jk, jh, jsf = z - 1, z, z, z, z, z
    names = ["mm_safe"] + (["ii0", "dd0"] if affine else []) \
        + ["mm_cov"] + (["ii_cov", "dd_cov"] if affine else [])
    nblk = B // block_pairs

    def block_live(s):
        return (~met).view(nblk, block_pairs).any(dim=1) & (s <= s_max)

    steps = torch.ones(nblk, dtype=torch.int32, device=dev)
    live = block_live(1)
    s = 1
    while bool(live.any()):
        rdr = lambda ring: _ring_reader(ring, s, Wd)
        if affine:
            Mf, If, Df, Mfp = _next_affine(model, rdr(fm), pattern, text,
                                           plen, tlen, ks, rdr(fi), rdr(fd),
                                           with_pre=True)
            Mr, Ir, Dr = _next_affine(model, rdr(rm), pat_rev, txt_rev, plen,
                                      tlen, ks, rdr(ri), rdr(rd))
            Mf, If, Df, Mfp = _prune_step(heur, plen, tlen, ks, Mf, If, Df,
                                          Mfp)
            Mr, Ir, Dr = _prune_step(heur, plen, tlen, ks, Mr, Ir, Dr)
        else:
            Mf, Mfp = _next_linear(model, rdr(fm), pattern, text, plen, tlen,
                                   ks, with_pre=True)
            Mr = _next_linear(model, rdr(rm), pat_rev, txt_rev, plen, tlen,
                              ks)
            Mf, Mfp = _prune_step(heur, plen, tlen, ks, Mf, Mfp)
            Mr = _prune_step(heur, plen, tlen, ks, Mr)
        row = s % Wd
        fm[row], fmp[row], rm[row] = Mf, Mfp, Mr
        if affine:
            fi[row], fd[row], ri[row], rd[row] = If, Df, Ir, Dr

        def at(ring, c):
            """Ring row at per-pair cost c [B] (NEG outside the window)."""
            ok = (c >= 0) & (c <= s) & (c > s - Wd)
            sel = ring[(c.clamp(min=0) % Wd).long(), bidx]
            return torch.where(ok[:, None], sel, NEG)

        def orient(a_m, a_g, b_m, b_g):
            """Candidate classes for prefix costs a_*, suffix costs b_*:
            {name: (mask [B,K], state, a, b, h [B,K], safe)}; a_m + b_m sum
            to starget (M/M), a_g + b_g to starget + o (gap joins)."""
            fa_m, fa_mp = at(fm, a_m), at(fmp, a_m)
            rb_m = comp(at(rm, b_m))
            vmm = (fa_m > _VALID_THRESH) & (rb_m > _VALID_THRESH)
            cov = vmm & (fa_m + rb_m >= m2)
            h_mm = torch.minimum(torch.maximum(m2 - rb_m, low),
                                 torch.maximum(fa_m, low))
            out = {"mm_safe": (cov & (fa_mp + rb_m <= m2), 0, a_m, b_m,
                               h_mm, 1),
                   "mm_cov": (cov, 0, a_m, b_m, h_mm, 0)}
            if affine:
                fa_i, rb_i = at(fi, a_g), comp(at(ri, b_g))
                fa_d, rb_d = at(fd, a_g), comp(at(rd, b_g))
                vii = (fa_i > _VALID_THRESH) & (rb_i > _VALID_THRESH)
                vdd = (fa_d > _VALID_THRESH) & (rb_d > _VALID_THRESH)
                out["ii0"] = (vii & (fa_i + rb_i == m2), 1, a_g, b_g, fa_i,
                              1)
                out["dd0"] = (vdd & (fa_d + rb_d == m2), 2, a_g, b_g, fa_d,
                              1)
                out["ii_cov"] = (vii & (fa_i + rb_i >= m2), 1, a_g, b_g,
                                 fa_i, 0)
                out["dd_cov"] = (vdd & (fa_d + rb_d >= m2), 2, a_g, b_g,
                                 fa_d, 0)
            return out

        sb = z + s
        st2 = starget - oend
        A = orient(sb, sb, st2 - s, st2 + o - s)
        Bo = orient(st2 - s, st2 + o - s, sb, sb)
        # priority: class by class, orientation A before B; a pair takes
        # the first slot that holds a lane, at its lowest lane
        slots = [side[name] for name in names for side in (A, Bo)]
        field = lambda i: torch.stack([sl[i] for sl in slots])
        const = lambda i: torch.tensor([sl[i] for sl in slots],
                                       dtype=torch.int32, device=dev)
        masks = field(0)                                    # [S, B, K]
        anyk = masks.any(dim=2)                             # [S, B]
        first = anyk.to(torch.int32).argmax(dim=0)          # [B]
        lane = masks[first, bidx].to(torch.int32).argmax(dim=1)
        take = ~met & anyk.any(dim=0)
        met = met | take
        jst = torch.where(take, const(1)[first], jst)
        ja = torch.where(take, field(2)[first, bidx], ja)
        jb = torch.where(take, field(3)[first, bidx], jb)
        jk = torch.where(take, lane.to(torch.int32) - kc, jk)
        jh = torch.where(take, field(4)[first, bidx, lane], jh)
        jsf = torch.where(take, const(5)[first], jsf)
        s += 1
        nxt = live & block_live(s)
        steps = torch.where(live & ~nxt, s, steps)
        live = nxt
    return met, jst, ja, jb, jk, jh, jsf, steps, s


def wfa_bidir_meet(pattern, text, plen, tlen, starget, *, pen, s_max: int,
                   k_max: int, heur=None, begin_state: str = "M",
                   end_state: str = "M", device=None) -> BidirMeetResult:
    """Meet-in-the-middle BiWFA breakpoint solver (O(s) memory).

    A forward wavefront on ``(p, t)`` and a reverse wavefront on the
    reversed pair step in lockstep, keeping only rolling windows of depth
    ``Wd = max(window, 2*max(x, o+e) + 2)``.  ``starget`` ([B]) is each
    pair's known optimal cost; the solver looks for a *breakpoint*: a cell
    reached forward at cost ``a`` and backward at cost ``b`` with ``a + b
    == starget`` (M/M) or ``a + b == starget + o`` (inside one gap run,
    I/I or D/D: both halves charge the open).  Forward diagonal ``k`` and
    reverse diagonal ``(m-n) - k`` address the same cell, and coverage
    ``h_f + h_r >= m`` on complementary diagonals joins both coordinates.
    Each step ``s`` examines the splits ``(s, T-s)`` and ``(T-s, s)``.

    An M/M candidate is provably exact when the split offset fits both
    furthest-reaching match runs (pre-extension forward value ``<= m -
    h_rev``); gap joins are exact at exact coverage; other coverage
    overshoots are accepted with ``meet_safe = 0`` (the BiWFA driver
    re-scores every stitched CIGAR).  A non-exact heuristic prunes both
    fronts as the forward solvers do.  Unresolved pairs have ``score =
    -1``.  The whole batch stops when every pair has met (or at
    ``s_max``); ``n_steps`` is that step.
    """
    model, heur = _resolve(pen, heur)
    _check_states(model, begin_state, end_state)
    pattern, text, plen, tlen = _prep(pattern, text, plen, tlen, device)
    starget = torch.as_tensor(starget, device=pattern.device).to(
        torch.int32).reshape(-1)
    B = pattern.shape[0]
    met, jst, ja, jb, jk, jh, jsf, _, s = _meet_lockstep(
        model, heur, pattern, text, _reverse_rows(pattern, plen),
        _reverse_rows(text, tlen), plen, tlen, starget, s_max=s_max,
        K=2 * k_max + 1, kc=k_max, begin_state=begin_state,
        end_state=end_state, met0=torch.zeros(B, dtype=torch.bool,
                                              device=pattern.device),
        block_pairs=max(B, 1))
    return BidirMeetResult(torch.where(met, starget, -1), s,
                           torch.where(met, jst, -1), ja, jb, jk, jh, jsf)


# ---------------------------------------------------------------------------
# Per-shard solving over a device mesh (the ``shardmap`` backend).


def shard_devices(mesh) -> List[torch.device]:
    """The device of each shard, in shard order: the pair axis splits over
    every mesh axis, and the mesh lists its devices row-major, as
    ``P(axis_names)`` lays them out."""
    return list(mesh.devices)


def wfa_shards(pattern, text, plen, tlen, *, pen, s_max: int, k_max: int,
               mesh, heur=None, band_cap=None,
               packed: bool = False) -> List[WFAResult]:
    """Each shard's :class:`WFAResult`, in shard order, on its device.

    Shard *i* takes rows ``[i*B/n, (i+1)*B/n)`` of the ``n`` shards of
    :func:`shard_devices` and runs :func:`wfa_scores` (with ``packed``:
    :func:`wfa_scores_packed`) on them: its own loop, its own early exit,
    nothing shared (the paper's "no inter-DPU communication").  ``B`` must
    split evenly, as under ``shard_map``.  On return, every card's current
    stream is ordered after its shards' work.
    """
    devices = shard_devices(mesh)
    n = len(devices)
    B = int(pattern.shape[0])
    if B % n:
        raise ValueError(f"{B} pairs do not split evenly over {n} shards")
    per = B // n
    solve = wfa_scores_packed if packed else wfa_scores
    kw = dict(pen=pen, s_max=s_max, k_max=k_max, heur=heur,
              band_cap=band_cap)
    # slices go to their devices from this thread, behind the caller's
    # streams (a copy between cards orders both cards' current streams)
    args = [[torch.as_tensor(a[i * per:(i + 1) * per]).to(
        dev, non_blocking=True) for a in (pattern, text, plen, tlen)]
        for i, dev in enumerate(devices)]
    if n == 1:
        return [solve(*args[0], device=devices[0], **kw)]
    # The ring loop asks the host every step whether any pair is left, so
    # shards on one thread would run one after another.  Each shard gets a
    # host thread of its own and, on a card, a CUDA stream of its own:
    # shards on several cards run side by side, and shards that share one
    # card interleave their steps on it.
    streams = [torch.cuda.Stream(dev) if dev.type == "cuda" else None
               for dev in devices]
    for st, dev, a in zip(streams, devices, args):
        if st is not None:
            st.wait_stream(torch.cuda.current_stream(dev))
            for t in a:
                t.record_stream(st)

    def run(i):
        if streams[i] is None:
            return solve(*args[i], device=devices[i], **kw)
        with torch.cuda.stream(streams[i]):
            return solve(*args[i], device=devices[i], **kw)

    with ThreadPoolExecutor(max_workers=n) as pool:
        futures = [pool.submit(run, i) for i in range(n)]
        out = [f.result() for f in futures]
    for st, dev, res in zip(streams, devices, out):
        if st is not None:
            caller = torch.cuda.current_stream(dev)
            caller.wait_stream(st)
            for t in res:
                if isinstance(t, torch.Tensor):
                    t.record_stream(caller)
    return out


def wfa_scores_shardmap(pattern, text, plen, tlen, *, pen, s_max: int,
                        k_max: int, mesh, heur=None,
                        band_cap=None) -> torch.Tensor:
    """PIM-faithful distributed WFA: each shard of the pair axis runs
    :func:`wfa_scores` to its own termination (:func:`wfa_shards`); the
    ``[B]`` scores come back concatenated on the first shard's device."""
    res = wfa_shards(pattern, text, plen, tlen, pen=pen, s_max=s_max,
                     k_max=k_max, mesh=mesh,
                     heur=heur, band_cap=band_cap)
    first = res[0].score.device
    return torch.cat([r.score.to(first) for r in res])


def wfa_trace_shardmap(pattern, text, plen, tlen, *, pen, s_max: int,
                       k_max: int, mesh, heur=None,
                       band_cap=None):
    """Per-shard packed-backtrace WFA: each shard runs
    :func:`wfa_scores_packed` to its own termination, so a settled pair
    keeps getting codes until its own shard exits.  Returns ``(score,
    m_bt, i_bt, d_bt)`` concatenated on the first shard's device, the words
    in the ``[n_words, B, k_pad]`` layout; ``i_bt = d_bt = None`` for
    linear models."""
    res = wfa_shards(pattern, text, plen, tlen, pen=pen, s_max=s_max,
                     k_max=k_max, mesh=mesh,
                     heur=heur, band_cap=band_cap, packed=True)
    first = res[0].score.device
    cat = lambda f, dim: (None if getattr(res[0], f) is None else torch.cat(
        [getattr(r, f).to(first) for r in res], dim=dim))
    return (cat("score", 0), cat("m_bt", 1), cat("i_bt", 1),
            cat("d_bt", 1))

"""Batched WFA kernel: the CUDA launcher and, beside it, its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/wfa/kernel.py::wfa_pallas``
(body ``_make_kernel``) in its score (``trace=False``) and packed-trace
(``trace=True``) variants, each at full width or on the compacting band
(``band_cap``), and ``wfa_meet_pallas`` (body ``_make_meet_kernel``), the
BiWFA meet search.  Both versions here compute exactly what the Pallas
kernels compute:

* pairs in blocks of ``block_pairs``; each block runs its own score loop
  and exits once all its pairs are resolved (or ``s`` passes ``s_max``);
* ``k_pad`` diagonal lanes per pair, centred at ``k_pad // 2``, or, with
  ``band_cap < k_pad``, ``band_cap`` lanes in a window per block that
  slides along those ``k_pad`` (the compacting band);
* rings of depth ``window`` (three for affine models, one for linear);
* outputs ``score [B, 1]`` (-1 over ``s_max``), ``steps [B, 1]`` (the
  block's exit step) and, with ``trace``, ``[n_words, B, k_pad]`` int32
  words of 2-bit codes from the pre-prune fronts (three planes for affine
  models, one for linear).

:func:`wfa_kernel` is the entry point: a CUDA tensor launches the kernel of
``csrc/wfa.cu`` (and raises if it cannot), a CPU tensor runs
:func:`wfa_plain`.  :func:`wfa_meet_kernel` does the same for the meet
search (``csrc/wfa_meet.cu`` / :func:`wfa_meet_plain`): forward and reverse
fronts, outputs eight ``[B, 1]`` int32 arrays (score, steps, state, a, b,
k, h, safe).  The plain version steps each block in lockstep over
``[Wd, B, k_pad]`` rings; the kernel runs one pair per CTA over the lanes
of :func:`meet_band`, tests only in :func:`meet_test_steps`, and
:func:`block_steps` turns its per-pair exit steps into the per-block
``steps``.  :data:`LAUNCHES` counts kernel launches per variant.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import scoring
from repro_torch.core import wavefront as wf
from repro_torch.core.scoring import AdaptiveBand, ZDrop
from repro_torch.obs import trace as obs_trace

# Kernel launches per variant ("score" / "trace" at full width,
# "score_band" / "trace_band" on the compacting band, "meet"); the plain
# versions do not count.
LAUNCHES = {"score": 0, "trace": 0, "score_band": 0, "trace_band": 0,
            "meet": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _check(pattern, text, plen, tlen, block_pairs, k_pad):
    B = pattern.shape[0]
    if B % block_pairs:
        raise ValueError(f"batch {B} is not a multiple of block_pairs "
                         f"{block_pairs}")
    if k_pad < 2 or k_pad % 2:
        raise ValueError(f"k_pad must be even, got {k_pad}")
    for name, t, shape in (("pattern", pattern, None), ("text", text, None),
                           ("plen", plen, (B, 1)), ("tlen", tlen, (B, 1))):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != pattern.device:
            raise ValueError(f"{name} is on {t.device}, pattern on "
                             f"{pattern.device}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dim() != 2 or t.shape[0] != B:
            raise ValueError(f"{name} must be [B, *], got {tuple(t.shape)}")


def wfa_plain(pattern, text, plen, tlen, *, pen, s_max: int, k_pad: int,
              block_pairs: int, trace: bool = False, heur=None,
              band_cap=None):
    """Plain PyTorch version of the kernel (any device).

    The whole batch steps together while any block is live; a block that
    has exited stops contributing trace codes, and its ``steps`` is the
    step at which it exited — what the per-block loop of the kernel gives.

    ``band_cap`` below ``k_pad`` runs the compacting band as the TPU kernel
    does: ``band_cap``-wide rings in a window per *block* (the union of its
    pairs' live lanes, M|I|D for affine models), offset ``off0`` at the
    centre, re-centred each step on the previous row, older rows realigned
    by the offset delta, codes scattered to absolute k.
    """
    model = scoring.as_model(pen)
    heur = scoring.as_heuristic(heur)
    _check(pattern, text, plen, tlen, block_pairs, k_pad)
    dev = pattern.device
    B = pattern.shape[0]
    nblk = B // block_pairs
    W = model.window
    affine = model.kind == "affine"
    band = band_cap is not None and band_cap < k_pad
    Kc = int(band_cap) if band else k_pad
    kc = k_pad // 2                      # absolute diagonal centre
    off0 = min(max(kc - Kc // 2, 0), k_pad - Kc)
    pl = plen[:, 0]
    tl = tlen[:, 0]
    jidx = torch.arange(Kc, dtype=torch.int32, device=dev)[None, :]
    rows = lambda v: v.repeat_interleave(block_pairs)    # [nblk] -> [B]
    new = lambda *shape: torch.full(shape, wf.NEG, dtype=torch.int32,
                                    device=dev)

    off = torch.full((B,), off0, dtype=torch.int32, device=dev)
    off_hist = torch.full((W, B), off0, dtype=torch.int32, device=dev)
    ks = jidx + (off - kc)[:, None]
    M0 = wf._extend(torch.where(ks == 0, 0, wf.NEG).to(torch.int32),
                    pattern, text, pl, tl, ks)
    m_ring = new(W, B, Kc)
    m_ring[0] = M0
    if affine:
        i_ring, d_ring = new(W, B, Kc), new(W, B, Kc)
    score = torch.where(wf._band_reached(M0, pl, tl, kc, off), 0,
                        -1).to(torch.int32)
    bts = ()
    if trace:
        NW = wf.n_trace_words(s_max)
        bts = tuple(torch.zeros((NW, B, k_pad), dtype=torch.int32,
                                device=dev)
                    for _ in range(3 if affine else 1))

    def block_live(s):
        open_ = (score < 0).view(nblk, block_pairs).any(dim=1)
        return open_ & (s <= s_max)

    def recenter(s):
        prow = (s - 1) % W
        live = m_ring[prow] > wf._VALID_THRESH
        if affine:
            # I/D fronts can outrun M between prunes: use the union
            live = (live | (i_ring[prow] > wf._VALID_THRESH)
                    | (d_ring[prow] > wf._VALID_THRESH))
        poff = off_hist[prow].view(nblk, block_pairs)[:, 0]
        return rows(wf._band_recenter(
            live.view(nblk, block_pairs, Kc).any(dim=1), poff, Kc, k_pad))

    steps = torch.ones(nblk, dtype=torch.int32, device=dev)
    live = block_live(1)
    s = 1
    while bool(live.any()):
        if band:
            off = recenter(s)
            ks = jidx + (off - kc)[:, None]
            read = lambda ring: (lambda d: wf._band_read(ring, off_hist, s,
                                                         d, off, W))
        else:
            read = lambda ring: wf._ring_reader(ring, s, W)
        if affine:
            out = wf._next_affine(model, read(m_ring), pattern, text, pl, tl,
                                  ks, read(i_ring), read(d_ring),
                                  with_codes=trace)
            M_new, I_new, D_new = out[:3]
            codes = out[3:]
        else:
            out = wf._next_linear(model, read(m_ring), pattern, text, pl, tl,
                                  ks, with_codes=trace)
            M_new, codes = (out[0], out[1:]) if trace else (out, ())
        reached = wf._band_reached(M_new, pl, tl, kc, off)
        score = torch.where((score < 0) & reached, s, score).to(torch.int32)
        keep = wf.keep_mask(heur, M_new, pl[:, None], tl[:, None], ks)
        row = s % W
        if affine:
            M_new, I_new, D_new = wf._pruned(keep, M_new, I_new, D_new)
            i_ring[row] = I_new
            d_ring[row] = D_new
        else:
            M_new = wf._pruned(keep, M_new)
        m_ring[row] = M_new
        off_hist[row] = off
        rows_live = rows(live)[:, None]
        for bt, code in zip(bts, codes):
            if band:
                code = wf._band_scatter(code, off, k_pad)
            wf._pack(bt, s, torch.where(rows_live, code, 0))
        s += 1
        nxt = live & block_live(s)
        steps = torch.where(live & ~nxt, s, steps)
        live = nxt
    steps = rows(steps)[:, None].to(torch.int32)
    return (score[:, None], steps) + bts


def _check_bytes(span: str, kernel: str, tensors) -> None:
    """Raise ``ValueError`` unless every code of ``tensors`` lies in [0,
    255]: the kernel compares characters as bytes, which is exact only
    there.  One reduction and one synchronisation, in the tracer span
    ``span``."""
    with obs_trace.span(span, cat="kernel"):
        wide = [((t < 0) | (t > 255)).any() for t in tensors if t.numel()]
        if wide and bool(torch.stack(wide).any()):
            raise ValueError(f"the {kernel} kernel compares characters as "
                             f"bytes: every code must lie in [0, 255]")


def _heur_args(heur):
    if heur.exact:
        return 0, 0, 0
    if isinstance(heur, AdaptiveBand):
        return 1, heur.min_wf_len, heur.max_distance_diff
    if isinstance(heur, ZDrop):
        return 2, heur.zdrop, 0
    raise TypeError(f"unknown heuristic {heur!r}")


def wfa_cuda(pattern, text, plen, tlen, *, pen, s_max: int, k_pad: int,
             block_pairs: int, trace: bool = False, heur=None,
             band_cap=None):
    """Launch the CUDA kernel on the current stream; same arguments and
    returns as :func:`wfa_plain`.  ``band_cap`` below ``k_pad`` launches the
    band kernel, which compares characters as bytes: every code must lie in
    [0, 255], and checking that costs one reduction and one synchronisation
    (span ``band.check_codes``); anything else raises.  The full-width
    kernel takes any codes and any ``block_pairs * k_pad``, runs on the
    lanes of :func:`full_lanes` and does not synchronise."""
    from repro_torch.kernels.wfa import build

    model = scoring.as_model(pen)
    heur = scoring.as_heuristic(heur)
    _check(pattern, text, plen, tlen, block_pairs, k_pad)
    if pattern.device.type != "cuda":
        raise ValueError(f"wfa_cuda needs CUDA tensors, got "
                         f"{pattern.device}")
    lib = build.load()
    pattern, text, plen, tlen = (t.contiguous()
                                 for t in (pattern, text, plen, tlen))
    dev = pattern.device
    B = pattern.shape[0]
    BP = block_pairs
    affine = model.kind == "affine"
    W = model.window
    band = band_cap is not None and band_cap < k_pad
    if band:
        _check_bytes("band.check_codes", "band", (pattern, text))
    i32 = dict(dtype=torch.int32, device=dev)
    score = torch.empty((B, 1), **i32)
    steps = torch.empty((B, 1), **i32)
    bts = ()
    if trace:
        NW = wf.n_trace_words(s_max)
        bts = tuple(torch.zeros((NW, B, k_pad), **i32)
                    for _ in range(3 if affine else 1))
    # rings and byte characters that do not fit shared memory go here (the
    # size is the CUDA source's to decide); freed on return: the caching
    # allocator orders any reuse after the kernel on this stream
    kind, hp1, hp2 = _heur_args(heur)
    ptr = lambda t: None if t is None else t.data_ptr()
    m_bt, i_bt, d_bt = (bts + (None, None, None))[:3]
    ptrs = (ptr(pattern), ptr(text), ptr(plen), ptr(tlen), ptr(score),
            ptr(steps), ptr(m_bt), ptr(i_bt), ptr(d_bt))
    dims = (B, pattern.shape[1], text.shape[1], BP, k_pad)
    rest = (int(s_max), model.x, model.o, model.e, W, int(affine),
            int(trace), kind, hp1, hp2)
    with torch.cuda.device(dev):     # the library sizes for the current card
        stream = torch.cuda.current_stream(dev).cuda_stream
        if band:
            Kc = int(band_cap)
            n_scratch = lib.wfa_band_scratch_ints(
                B, BP, Kc, W, int(affine), int(trace), *dims[1:3])
            scratch = torch.empty(n_scratch, **i32) if n_scratch else None
            rc = lib.wfa_band_launch(*ptrs, ptr(scratch), *dims, Kc, *rest,
                                     stream)
        else:
            lanes = full_lanes(model, s_max, k_pad)
            n_scratch = lib.wfa_scratch_ints(B, BP, k_pad, *lanes, W,
                                             model.e, int(affine), *dims[1:3])
            scratch = torch.empty(n_scratch, **i32) if n_scratch else None
            rc = lib.wfa_launch(*ptrs, ptr(scratch), *dims, *lanes, *rest,
                                stream)
    if rc != 0:
        raise RuntimeError(f"WFA kernel launch failed: "
                           f"{lib.wfa_error_string(rc).decode()} ({rc})")
    variant = "trace" if trace else "score"
    LAUNCHES[f"{variant}_band" if band else variant] += 1
    return (score, steps) + bts


def wfa_kernel(pattern, text, plen, tlen, *, pen, s_max: int, k_pad: int,
               block_pairs: int, trace: bool = False, heur=None,
               band_cap=None):
    """-> (score [B,1], steps [B,1]) plus, with ``trace``, the packed code
    planes.  CUDA tensors run the CUDA kernel; CPU tensors the plain
    version."""
    fn = wfa_cuda if pattern.device.type == "cuda" else wfa_plain
    return fn(pattern, text, plen, tlen, pen=pen, s_max=s_max, k_pad=k_pad,
              block_pairs=block_pairs, trace=trace, heur=heur,
              band_cap=band_cap)


def _check_meet(pattern, text, pat_rev, txt_rev, plen, tlen, starget,
                block_pairs, k_pad):
    _check(pattern, text, plen, tlen, block_pairs, k_pad)
    B = pattern.shape[0]
    for name, t, shape in (("pat_rev", pat_rev, tuple(pattern.shape)),
                           ("txt_rev", txt_rev, tuple(text.shape)),
                           ("starget", starget, (B, 1))):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != pattern.device:
            raise ValueError(f"{name} is on {t.device}, pattern on "
                             f"{pattern.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")


_EMPTY = (1 << 30, -1)   # (lo, hi) of a range that holds no lane


@functools.lru_cache(maxsize=64)
def _meet_band(x, o, e, affine, s_max, k_pad, seeds):
    out = np.empty((s_max + 1, 2, 3, 2), np.int32)
    clip = lambda lo, hi: ((max(lo, 0), min(hi, k_pad - 1))
                           if max(lo, 0) <= min(hi, k_pad - 1) else _EMPTY)
    hull = lambda *rs: clip(min(r[0] for r in rs), max(r[1] for r in rs))
    shift = lambda r, d: _EMPTY if r[0] > r[1] else clip(r[0] + d, r[1] + d)
    kc = k_pad // 2
    for f, seed in enumerate(seeds):
        rows = out[:, f]
        back = lambda s, d, ring: (tuple(rows[s - d, ring]) if s >= d
                                   else _EMPTY)
        rows[0, 0] = (kc, kc)
        rows[0, 1] = (kc, kc) if seed == "I" else _EMPTY
        rows[0, 2] = (kc, kc) if seed == "D" else _EMPTY
        for s in range(1, s_max + 1):
            if affine:
                m_oe = back(s, o + e, 0)
                ri = shift(hull(m_oe, back(s, e, 1)), 1)
                rd = shift(hull(m_oe, back(s, e, 2)), -1)
                rm = hull(back(s, x, 0), ri, rd)
            else:
                m_e = back(s, e, 0)
                ri = rd = _EMPTY
                rm = hull(back(s, x, 0), shift(m_e, 1), shift(m_e, -1))
            rows[s] = (rm, ri, rd)
    out.flags.writeable = False
    return out


def meet_band(pen, s_max: int, k_pad: int, begin_state: str = "M",
              end_state: str = "M"):
    """The lanes the meet search's recurrence can reach -> ``[s_max + 1, 2,
    3, 2]`` int32 numpy: for each score step, front (forward, reverse) and
    ring (M, I, D), the inclusive lane range ``(lo, hi)`` outside which the
    ring's row is ``NEG`` (``lo > hi``: no lane).

    Lane ``kc = k_pad // 2`` holds M at s = 0, and I or D there when the
    front's boundary state (``begin_state`` forward, ``end_state`` reverse)
    seeds it.  Then I at s reaches one lane above M at ``s - (o+e)`` and I
    at ``s - e``, D one lane below (with D), and M the union of M at
    ``s - x`` and both gaps; a linear model keeps M only, from M at ``s -
    x`` and one lane either side of M at ``s - e``.  Ranges are clipped to
    ``[0, k_pad)``.  Neither the data nor a heuristic's pruning can widen
    them, so the rule bounds every pair and heuristic; the kernel computes,
    stores and reads only inside the M range of each front."""
    model = scoring.as_model(pen)
    return _meet_band(model.x, model.o, model.e, model.kind == "affine",
                      int(s_max), int(k_pad), (begin_state, end_state))


def full_lanes(pen, s_max: int, k_pad: int):
    """The lanes the full-width kernel runs on -> ``(lo, hi)``, inclusive:
    the hull over steps 0 to ``s_max`` of :func:`meet_band`'s forward M
    range, in closed form.  A front moves one lane off its diagonal per gap
    step: a gap opened at ``o + e`` and extended every ``e`` after reaches
    ``d = 1 + (s_max - o - e) // e`` lanes either side of ``kc = k_pad //
    2`` (affine; ``s_max // e`` for linear models), clipped to ``[0,
    k_pad)``.  No lane outside it is ever live, whatever the data or the
    heuristic."""
    model = scoring.as_model(pen)
    s_max, kc = max(int(s_max), 0), int(k_pad) // 2
    if model.kind == "affine":
        oe = model.o + model.e
        d = 0 if s_max < oe else 1 + (s_max - oe) // model.e
    else:
        d = s_max // model.e
    return max(kc - d, 0), min(kc + d, int(k_pad) - 1)


@functools.lru_cache(maxsize=64)
def _meet_band_on(device, pen, s_max, k_pad, begin_state, end_state):
    """The M ranges of :func:`meet_band` as the ``[s_max + 1, 2, 2]``
    table the meet kernel reads, copied to ``device`` once per shape."""
    return torch.from_numpy(np.ascontiguousarray(meet_band(
        pen, s_max, k_pad, begin_state, end_state)[:, :, 0, :])).to(device)


def meet_test_steps(starget, pen, end_state: str = "M"):
    """-> (first, stop): per pair, the first score step whose meet test can
    hold a lane, and the step from which none can.

    At step s the test reads the forward rows at s and at ``st2 - s`` (M
    classes) or ``st2 + o - s`` (gap classes), and the reverse rows at the
    other cost, with ``st2 = starget`` less ``o`` under an I or D end state;
    a row is visible only at costs in ``(s - Wd, s]``.  So nothing can hold
    while ``2s < st2``, and nothing from ``2s >= st2 + o + Wd`` on."""
    model = scoring.as_model(pen)
    o = model.o if model.kind == "affine" else 0
    st2 = starget.to(torch.int64) - (o if end_state != "M" else 0)
    first = torch.clamp((st2 + 1).div(2, rounding_mode="floor"), min=1)
    stop = (st2 + o + wf.meet_window(model) + 1).div(
        2, rounding_mode="floor")
    return first, stop


def block_steps(exit_steps, block_pairs: int):
    """Per-pair exit steps ``[B, 1]`` -> each block's exit step on its rows:
    the max over its ``block_pairs`` rows (a pair's exit step is its meet
    step + 1, 1 for a padded row, ``s_max + 1`` unmet)."""
    blk = exit_steps.view(-1, block_pairs).amax(dim=1, keepdim=True)
    return blk.repeat_interleave(block_pairs, dim=0).view(-1, 1)


def wfa_meet_plain(pattern, text, pat_rev, txt_rev, plen, tlen, starget, *,
                   pen, s_max: int, k_pad: int, block_pairs: int, heur=None,
                   begin_state: str = "M", end_state: str = "M"):
    """Plain PyTorch version of the meet kernel (any device).

    The shared lockstep solver of ``core.wavefront`` at the kernel's
    conventions: ``k_pad`` lanes centred at ``k_pad // 2``, pairs in blocks
    with a per-block exit step, and padded rows (``plen = tlen = 0``)
    counted as met from the start but reported unmet.
    -> (score, steps, state, a, b, k, h, safe), each ``[B, 1]`` int32.
    """
    model = scoring.as_model(pen)
    heur = scoring.as_heuristic(heur)
    wf._check_states(model, begin_state, end_state)
    _check_meet(pattern, text, pat_rev, txt_rev, plen, tlen, starget,
                block_pairs, k_pad)
    pl, tl, st = plen[:, 0], tlen[:, 0], starget[:, 0]
    met0 = (pl == 0) & (tl == 0)
    met, jst, ja, jb, jk, jh, jsf, steps, _ = wf._meet_lockstep(
        model, heur, pattern, text, pat_rev, txt_rev, pl, tl, st,
        s_max=int(s_max), K=k_pad, kc=k_pad // 2, begin_state=begin_state,
        end_state=end_state, met0=met0, block_pairs=block_pairs)
    hit = met & ~met0
    cols = (torch.where(hit, st, -1),
            steps.repeat_interleave(block_pairs),
            torch.where(hit, jst, -1), ja, jb, jk, jh, jsf)
    return tuple(c.to(torch.int32)[:, None] for c in cols)


def wfa_meet_cuda(pattern, text, pat_rev, txt_rev, plen, tlen, starget, *,
                  pen, s_max: int, k_pad: int, block_pairs: int, heur=None,
                  begin_state: str = "M", end_state: str = "M"):
    """Launch the CUDA meet kernel on the current stream; same arguments
    and returns as :func:`wfa_meet_plain`.  The kernel compares characters
    as bytes, so every code must lie in [0, 255]: checking that costs one
    reduction and one synchronisation (span ``meet.check_codes``), and
    anything else raises."""
    from repro_torch.kernels.wfa import build

    model = scoring.as_model(pen)
    heur = scoring.as_heuristic(heur)
    wf._check_states(model, begin_state, end_state)
    _check_meet(pattern, text, pat_rev, txt_rev, plen, tlen, starget,
                block_pairs, k_pad)
    if pattern.device.type != "cuda":
        raise ValueError(f"wfa_meet_cuda needs CUDA tensors, got "
                         f"{pattern.device}")
    lib = build.load()
    ins = tuple(t.contiguous() for t in (pattern, text, pat_rev, txt_rev,
                                         plen, tlen, starget))
    dev = pattern.device
    B = pattern.shape[0]
    _check_bytes("meet.check_codes", "meet", ins[:4])
    affine = model.kind == "affine"
    Wd = wf.meet_window(model)
    De = model.e + 1 if affine else 0
    band = _meet_band_on(dev, model, max(int(s_max), 0), k_pad, begin_state,
                         end_state)
    outs = tuple(torch.empty((B, 1), dtype=torch.int32, device=dev)
                 for _ in range(8))
    kind, hp1, hp2 = _heur_args(heur)
    n_scratch = lib.wfa_meet_scratch_ints(B, pattern.shape[1],
                                          text.shape[1], k_pad, Wd,
                                          model.window, De, int(affine))
    scratch = torch.empty(n_scratch, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):     # launch on the tensors' card
        rc = lib.wfa_meet_launch(
            *(t.data_ptr() for t in ins + (band,) + outs),
            scratch.data_ptr(), B, pattern.shape[1], text.shape[1], k_pad,
            int(s_max), model.x, model.o, model.e, Wd, model.window, De,
            int(affine), kind, hp1, hp2, wf.STATES.index(begin_state),
            wf.STATES.index(end_state),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"WFA meet kernel launch failed: "
                           f"{lib.wfa_error_string(rc).decode()} ({rc})")
    LAUNCHES["meet"] += 1
    # the kernel writes each pair's exit step; a block exits at its last
    score, steps, *rest = outs
    return (score, block_steps(steps, block_pairs), *rest)


def wfa_meet_kernel(pattern, text, pat_rev, txt_rev, plen, tlen, starget, *,
                    pen, s_max: int, k_pad: int, block_pairs: int,
                    heur=None, begin_state: str = "M",
                    end_state: str = "M"):
    """-> the eight ``[B, 1]`` meet outputs.  CUDA tensors run the CUDA
    kernel; CPU tensors the plain version."""
    fn = wfa_meet_cuda if pattern.device.type == "cuda" else wfa_meet_plain
    return fn(pattern, text, pat_rev, txt_rev, plen, tlen, starget, pen=pen,
              s_max=s_max, k_pad=k_pad, block_pairs=block_pairs, heur=heur,
              begin_state=begin_state, end_state=end_state)

"""Batched WFA kernel: the CUDA launcher and, beside it, its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/wfa/kernel.py::wfa_pallas``
(body ``_make_kernel``) in its score (``trace=False``) and packed-trace
(``trace=True``) variants; the compacting band (``band_cap``) is not ported
yet.  Both versions here compute exactly what the Pallas kernel computes:

* pairs in blocks of ``block_pairs``; each block runs its own score loop
  and exits once all its pairs are resolved (or ``s`` passes ``s_max``);
* ``k_pad`` diagonal lanes per pair, centred at ``k_pad // 2``;
* rings of depth ``window`` (three for affine models, one for linear);
* outputs ``score [B, 1]`` (-1 over ``s_max``), ``steps [B, 1]`` (the
  block's exit step) and, with ``trace``, ``[n_words, B, k_pad]`` int32
  words of 2-bit codes from the pre-prune fronts (three planes for affine
  models, one for linear).

:func:`wfa_kernel` is the entry point: a CUDA tensor launches the kernel of
``csrc/wfa.cu`` (and raises if it cannot), a CPU tensor runs
:func:`wfa_plain`.  :data:`LAUNCHES` counts kernel launches per variant.
"""
from __future__ import annotations

import torch

from repro_torch.core import scoring
from repro_torch.core import wavefront as wf
from repro_torch.core.scoring import AdaptiveBand, ZDrop

# Kernel launches per variant ("score" / "trace"); the plain version does
# not count.
LAUNCHES = {"score": 0, "trace": 0}


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
              block_pairs: int, trace: bool = False, heur=None):
    """Plain PyTorch version of the kernel (any device).

    The whole batch steps together while any block is live; a block that
    has exited stops contributing trace codes, and its ``steps`` is the
    step at which it exited — what the per-block loop of the kernel gives.
    """
    model = scoring.as_model(pen)
    heur = scoring.as_heuristic(heur)
    _check(pattern, text, plen, tlen, block_pairs, k_pad)
    dev = pattern.device
    B = pattern.shape[0]
    nblk = B // block_pairs
    W = model.window
    affine = model.kind == "affine"
    kc = k_pad // 2
    pl = plen[:, 0]
    tl = tlen[:, 0]
    ks = torch.arange(k_pad, dtype=torch.int32, device=dev) - kc
    new = lambda *shape: torch.full(shape, wf.NEG, dtype=torch.int32,
                                    device=dev)

    seed = new(B, k_pad)
    seed[:, kc] = 0
    M0 = wf._extend(seed, pattern, text, pl, tl, ks)
    m_ring = new(W, B, k_pad)
    m_ring[0] = M0
    if affine:
        i_ring, d_ring = new(W, B, k_pad), new(W, B, k_pad)
    score = torch.where(wf._target_reached(M0, pl, tl, kc), 0,
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

    steps = torch.ones(nblk, dtype=torch.int32, device=dev)
    live = block_live(1)
    s = 1
    while bool(live.any()):
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
        reached = wf._target_reached(M_new, pl, tl, kc)
        score = torch.where((score < 0) & reached, s, score).to(torch.int32)
        row = s % W
        if affine:
            M_new, I_new, D_new = wf._prune_step(heur, pl, tl, ks, M_new,
                                                 I_new, D_new)
            i_ring[row] = I_new
            d_ring[row] = D_new
        else:
            M_new = wf._prune_step(heur, pl, tl, ks, M_new)
        m_ring[row] = M_new
        rows_live = live.repeat_interleave(block_pairs)[:, None]
        for bt, code in zip(bts, codes):
            wf._pack(bt, s, torch.where(rows_live, code, 0))
        s += 1
        nxt = live & block_live(s)
        steps = torch.where(live & ~nxt, s, steps)
        live = nxt
    steps = steps.repeat_interleave(block_pairs)[:, None].to(torch.int32)
    return (score[:, None], steps) + bts


def _heur_args(heur):
    if heur.exact:
        return 0, 0, 0
    if isinstance(heur, AdaptiveBand):
        return 1, heur.min_wf_len, heur.max_distance_diff
    if isinstance(heur, ZDrop):
        return 2, heur.zdrop, 0
    raise TypeError(f"unknown heuristic {heur!r}")


def wfa_cuda(pattern, text, plen, tlen, *, pen, s_max: int, k_pad: int,
             block_pairs: int, trace: bool = False, heur=None):
    """Launch the CUDA kernel on the current stream (no synchronisation);
    same arguments and returns as :func:`wfa_plain`."""
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
    if trace and BP * k_pad > lib.wfa_max_trace_cells():
        raise ValueError(
            f"trace kernel takes block_pairs * k_pad <= "
            f"{lib.wfa_max_trace_cells()}, got {BP} * {k_pad}; lower "
            f"block_pairs")
    i32 = dict(dtype=torch.int32, device=dev)
    score = torch.empty((B, 1), **i32)
    steps = torch.empty((B, 1), **i32)
    bts = ()
    if trace:
        NW = wf.n_trace_words(s_max)
        bts = tuple(torch.zeros((NW, B, k_pad), **i32)
                    for _ in range(3 if affine else 1))
    # rings that do not fit shared memory go here (the size is the CUDA
    # source's to decide); freed on return: the caching allocator orders
    # any reuse after the kernel on this stream
    kind, hp1, hp2 = _heur_args(heur)
    ptr = lambda t: None if t is None else t.data_ptr()
    m_bt, i_bt, d_bt = (bts + (None, None, None))[:3]
    with torch.cuda.device(dev):     # the library sizes for the current card
        n_scratch = lib.wfa_scratch_ints(B, BP, k_pad, W, int(affine))
        scratch = torch.empty(n_scratch, **i32) if n_scratch else None
        rc = lib.wfa_launch(
            ptr(pattern), ptr(text), ptr(plen), ptr(tlen), ptr(score),
            ptr(steps), ptr(m_bt), ptr(i_bt), ptr(d_bt), ptr(scratch),
            B, pattern.shape[1], text.shape[1], BP, k_pad, int(s_max),
            model.x, model.o, model.e, W, int(affine), int(trace), kind,
            hp1, hp2, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"WFA kernel launch failed: "
                           f"{lib.wfa_error_string(rc).decode()} ({rc})")
    LAUNCHES["trace" if trace else "score"] += 1
    return (score, steps) + bts


def wfa_kernel(pattern, text, plen, tlen, *, pen, s_max: int, k_pad: int,
               block_pairs: int, trace: bool = False, heur=None):
    """-> (score [B,1], steps [B,1]) plus, with ``trace``, the packed code
    planes.  CUDA tensors run the CUDA kernel; CPU tensors the plain
    version."""
    fn = wfa_cuda if pattern.device.type == "cuda" else wfa_plain
    return fn(pattern, text, plen, tlen, pen=pen, s_max=s_max, k_pad=k_pad,
              block_pairs=block_pairs, trace=trace, heur=heur)

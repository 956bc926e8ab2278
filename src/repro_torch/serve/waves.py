"""Deadline-or-full continuous batching: requests -> well-formed waves.

The engine's specialisation cache stays warm (no new specialisation) only
when traffic keeps arriving in the same few rectangular shapes; independent
requests arrive one at a time in whatever shape they like.  The
:class:`WaveFormer` is the adapter: it accumulates compatible requests —
same resolved (penalty model, heuristic, output mode), greedily grouped
by the power-of-two length bucket their longest sequence lands in — and
flushes a group as one wave when either

* it is **full** (``wave_pairs`` rows — the MRAM-capacity analogue), or
* the **forming deadline** of its oldest member expires
  (``arrival + min(form_deadline, request.deadline)``): a lonely request
  rides a mostly-padding wave rather than waiting forever for company.

``pad_to_full`` (the default) pads every flushed wave up to ``wave_pairs``
rows with self-aligning dummy rows *in the same length bucket*, so the
session dispatches exactly one batch shape per (bucket, seams) key and
the specialisation cache stays warm even for deadline-flushed stragglers —
the padding cost is visible, not hidden: it is exactly what
``ServerStats.padding_waste_frac`` reports.

Requests larger than a wave are split across consecutive waves of the
same group; delivery tracks per-request outstanding rows, so a split
request still resolves exactly once.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.engine import _fit_width, _next_pow2
from repro_torch.serve.request import AlignRequest

__all__ = ["FormedWave", "WaveFormer", "WaveSlice"]


@dataclasses.dataclass
class WaveSlice:
    """Rows ``[row_lo, row_lo + n)`` of a wave belong to ``request`` rows
    ``[req_lo, req_lo + n)``."""
    request: AlignRequest
    req_lo: int
    row_lo: int
    n: int


@dataclasses.dataclass
class FormedWave:
    """One flush-ready wave: stacked arrays + the slices that own them."""
    key: tuple                   # (pen, heur, output, bucket)
    slices: List[WaveSlice]
    p: np.ndarray
    plen: np.ndarray
    t: np.ndarray
    tlen: np.ndarray
    n_real: int                  # request rows (excludes pad rows)
    reason: str                  # "full" | "deadline" | "drain"

    @property
    def n_rows(self) -> int:
        return int(self.p.shape[0])


class _Group:
    """One forming bucket: compatible request slices awaiting flush."""

    def __init__(self, key: tuple):
        self.key = key
        self.members: List[Tuple[AlignRequest, int, int]] = []  # (req, lo, hi)
        self.n_rows = 0
        self.deadline: Optional[float] = None    # oldest member's

    def add(self, req: AlignRequest, lo: int, hi: int,
            member_deadline: float) -> None:
        self.members.append((req, lo, hi))
        self.n_rows += hi - lo
        if self.deadline is None or member_deadline < self.deadline:
            self.deadline = member_deadline


class WaveFormer:
    """Groups compatible requests into deadline-or-full waves."""

    def __init__(self, wave_pairs: int, form_deadline: float, *,
                 min_bucket_len: int = 16, pad_to_full: bool = True):
        if wave_pairs < 1:
            raise ValueError("wave_pairs must be >= 1")
        if form_deadline <= 0:
            raise ValueError("form_deadline must be > 0")
        self.wave_pairs = int(wave_pairs)
        self.form_deadline = float(form_deadline)
        self.min_bucket_len = int(min_bucket_len)
        self.pad_to_full = bool(pad_to_full)
        self._groups: Dict[tuple, _Group] = {}
        self._full: List[_Group] = []
        self.n_formed = 0

    # -- state ---------------------------------------------------------------

    @property
    def n_pending(self) -> int:
        """Rows accumulated but not yet flushed."""
        return (sum(g.n_rows for g in self._groups.values())
                + sum(g.n_rows for g in self._full))

    def next_deadline(self) -> Optional[float]:
        """Earliest forming deadline across open groups (loop wake-up)."""
        deadlines = [g.deadline for g in self._groups.values()
                     if g.deadline is not None]
        return min(deadlines) if deadlines else None

    # -- accumulate ----------------------------------------------------------

    def add(self, req: AlignRequest, now: float) -> None:
        """File one admitted request into its forming group (splitting
        across waves when it is larger than ``wave_pairs``)."""
        bucket = _next_pow2(max(req.max_len, self.min_bucket_len))
        key = (req.pen, req.heur, req.out, bucket)
        member_deadline = now + self.form_deadline
        if req.deadline is not None:
            member_deadline = min(member_deadline, now + req.deadline)
        lo = 0
        while lo < req.n_pairs:
            group = self._groups.get(key)
            if group is None:
                group = self._groups[key] = _Group(key)
            space = self.wave_pairs - group.n_rows
            hi = min(req.n_pairs, lo + space)
            group.add(req, lo, hi, member_deadline)
            if group.n_rows >= self.wave_pairs:
                self._full.append(self._groups.pop(key))
            lo = hi

    # -- flush ---------------------------------------------------------------

    def take_ready(self, now: float) -> List[FormedWave]:
        """Pop every full group plus every group whose oldest member's
        forming deadline has expired."""
        out = [self._build(g, "full") for g in self._full]
        self._full = []
        for key in [k for k, g in self._groups.items()
                    if g.deadline is not None and g.deadline <= now]:
            out.append(self._build(self._groups.pop(key), "deadline"))
        return out

    def flush_all(self) -> List[FormedWave]:
        """Drain every forming group (shutdown path)."""
        out = [self._build(g, "full") for g in self._full]
        self._full = []
        out.extend(self._build(g, "drain")
                   for g in self._groups.values())
        self._groups.clear()
        return out

    def _build(self, group: _Group, reason: str) -> FormedWave:
        width = 1
        lmax = 1
        for req, lo, hi in group.members:
            width = max(width, req.p.shape[1], req.t.shape[1])
            lmax = max(lmax, int(req.plen[lo:hi].max(initial=1)),
                       int(req.tlen[lo:hi].max(initial=1)))
        ps, ts, plens, tlens, slices = [], [], [], [], []
        row = 0
        for req, lo, hi in group.members:
            ps.append(_fit_width(req.p[lo:hi], width))
            ts.append(_fit_width(req.t[lo:hi], width))
            plens.append(req.plen[lo:hi])
            tlens.append(req.tlen[lo:hi])
            slices.append(WaveSlice(req, lo, row, hi - lo))
            row += hi - lo
        n_real = row
        if self.pad_to_full and n_real < self.wave_pairs:
            # self-aligning pad rows (zeros vs zeros, full bucket length):
            # they land in the same length bucket as the real rows, so the
            # padded wave is the SAME specialisation as a full one — no
            # new one even for a deadline-flushed lonely request.
            n_pad = self.wave_pairs - n_real
            pad_len = min(lmax, width)
            ps.append(np.zeros((n_pad, width), np.int32))
            ts.append(np.zeros((n_pad, width), np.int32))
            plens.append(np.full((n_pad,), pad_len, np.int32))
            tlens.append(np.full((n_pad,), pad_len, np.int32))
        self.n_formed += 1
        return FormedWave(
            key=group.key, slices=slices,
            p=np.concatenate(ps), plen=np.concatenate(plens),
            t=np.concatenate(ts), tlen=np.concatenate(tlens),
            n_real=n_real, reason=reason)

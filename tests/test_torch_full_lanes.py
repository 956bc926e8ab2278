"""The host-side rules the full-width CUDA kernel relies on, on the CPU.

* ``kernel.full_lanes``, the lanes the kernel's threads and rings cover, is
  the hull over steps 0 to ``s_max`` of ``kernel.meet_band``'s forward M
  range, clipped to ``[0, k_pad)``;
* in the JAX package's full-history fronts
  (``repro.core.wavefront.wfa_forward(keep_history=True)``), over the three
  penalty models crossed with exact, AdaptiveBand and ZDrop:

  - no lane outside ``full_lanes`` is ever live (M, I or D);
  - the per-row span rule: the live lanes of row s (M | I | D) lie in the
    hull of the live spans of the rows the step reads, row s - x and one
    lane either side of rows s - (o + e) and s - e (s - e for both under a
    linear model), so a 32-lane chunk outside that hull has nothing to do;
  - rows hold dead lanes inside their live span (under both heuristics,
    and exact for the affine and linear models), so a lane inside a span is
    read as it was stored, not assumed live.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import scoring as j_scoring  # noqa: E402
from repro.core import wavefront as j_wf  # noqa: E402
from repro.core.engine import problem_bounds  # noqa: E402
from repro.data.reads import ReadPairSpec, generate_pairs  # noqa: E402
from repro_torch.core import scoring as t_scoring  # noqa: E402
from repro_torch.kernels.wfa import kernel as t_kernel  # noqa: E402

NEG = j_wf.NEG
MODELS = (j_scoring.GapAffine(), j_scoring.GapLinear(), j_scoring.Edit())
HEURS = (None, j_scoring.AdaptiveBand(10, 4), j_scoring.ZDrop(8))
CASES = [(m, h) for m in MODELS for h in HEURS]
_id = lambda c: (f"{type(c[0]).__name__}-"
                 f"{type(c[1]).__name__ if c[1] else 'exact'}")


@pytest.mark.parametrize("pen", [
    t_scoring.GapAffine(4, 6, 2), t_scoring.GapAffine(3, 0, 1),
    t_scoring.GapAffine(1, 9, 4), t_scoring.GapLinear(),
    t_scoring.GapLinear(2, 3), t_scoring.Edit()], ids=str)
def test_full_lanes_is_the_hull_of_meet_band(pen):
    """Over step caps below, at and past the k_pad edge, and k_pad not a
    multiple of 128."""
    for k_pad in (128, 384, 250, 4992):
        for s_max in (0, 1, 5, 8, 38, 101, 416, 4928):
            band = t_kernel.meet_band(pen, s_max, k_pad)[:, 0, 0]
            live = band[:, 0] <= band[:, 1]
            want = (int(band[live, 0].min()), int(band[live, 1].max()))
            assert t_kernel.full_lanes(pen, s_max, k_pad) == want, (
                k_pad, s_max)
    # the paper's pass 1 at 100 bp: kc +- 16 of 128 lanes
    assert t_kernel.full_lanes(t_scoring.GapAffine(4, 6, 2), 38, 128) == (
        48, 80)


def _histories(pen, heur):
    """The JAX fronts of 16 pairs of 120 bp at E = 10% (those of
    tests/test_torch_wfa_gpu.py::test_cuda_full_pruning_holes) -> (live
    [S+1, B, K] bool of M | I | D, k_max, s_max)."""
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=16, read_len=120, edit_frac=0.1, seed=27))
    s_max, k_max = problem_bounds(j_scoring.GapAffine(), plen, tlen, None)
    res = j_wf.wfa_forward(P, T, plen, tlen, pen=pen, s_max=s_max,
                           k_max=k_max, keep_history=True, heur=heur)
    live = np.asarray(res.m_hist) != NEG
    for h in (res.i_hist, res.d_hist):
        if h is not None:
            live |= np.asarray(h) != NEG
    return live, k_max, s_max


def _spans(live):
    """Per row and pair, the lowest and highest live lane -> lo, hi [S+1,
    B] (lo > hi where none)."""
    K = live.shape[-1]
    lanes = np.arange(K)
    lo = np.where(live, lanes, K + 10).min(axis=-1)
    hi = np.where(live, lanes, -10).max(axis=-1)
    return lo, hi


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_full_width_rules_bound_full_history(case):
    pen, heur = case
    live, k_max, s_max = _histories(pen, heur)
    S1, B, K = live.shape
    t_pen = t_scoring.from_reference(pen)
    # static lanes: |k| <= d, d from full_lanes on lanes wide enough not to
    # clip (the histories clip at +- k_max themselves)
    kc = K + 1
    d = t_kernel.full_lanes(t_pen, s_max, 2 * kc)[1] - kc
    k = np.arange(K) - k_max
    assert not live[:, :, np.abs(k) > d].any()
    # the per-row span rule
    lo, hi = _spans(live)
    x, e = t_pen.x, t_pen.e
    oe = t_pen.o + e if t_pen.kind == "affine" else e
    empty = (np.full(B, K + 10), np.full(B, -10))
    row = lambda s: (lo[s], hi[s]) if s >= 0 else empty
    checked = holes = 0
    for s in range(1, S1):
        (lx, hx), (lg, hg), (le, he) = row(s - x), row(s - oe), row(s - e)
        clo = np.minimum(lx, np.minimum(lg, le) - 1)
        chi = np.maximum(hx, np.maximum(hg, he) + 1)
        has = lo[s] <= hi[s]
        assert (lo[s][has] >= clo[has]).all() and \
            (hi[s][has] <= chi[has]).all(), s
        checked += int(has.sum())
        for b in np.nonzero(has)[0]:
            holes += int((~live[s, b, lo[s][b]:hi[s][b] + 1]).sum())
    assert checked > 100
    # dead lanes inside a live span: every case but Edit's exact and
    # AdaptiveBand fronts, which stay contiguous on these pairs
    assert (holes > 0) == (_id(case) not in ("Edit-exact",
                                             "Edit-AdaptiveBand")), holes

"""Alignment backend registry.

A *backend* is one way to evaluate a batch of WFA problems on the device.
The engine (``core.engine``) plans buckets, sizes the static ``(s_max,
k_max)`` bounds, caches specialisations and recovers overflow pairs, then
hands each rectangular batch to the backend the user named.  New strategies
plug in with :func:`register_backend`.

Contract — a backend callable has the signature::

    fn(pattern, text, plen, tlen, *, pen, s_max, k_max, **extra) -> WFAResult

with ``pattern``/``text`` ``[B, L]`` int32 tensors on the engine's device,
``plen``/``tlen`` ``[B]`` int32, and ``pen`` a
:class:`~repro_torch.core.scoring.PenaltyModel`.  A backend that understands
wavefront heuristics takes a ``heur`` keyword; the engine passes it only
when a non-exact heuristic is requested.  ``BackendSpec.models`` names the
recurrence kinds a backend serves (plug-ins default to affine-only).

Every backend serves the score output through ``fn``; ``trace_variant``
(same signature) also returns the packed 2-bit provenance words
(``m_bt``/``i_bt``/``d_bt``) that ``core.cigar`` decodes into CIGARs, or,
the ``kernel`` backend on a card, those words already decoded there
(``ops``/``n_ops``/``status``).
``meet_variant`` (optional; the signature and ``BidirMeetResult`` of
``core.wavefront.wfa_bidir_meet``) serves the BiWFA driver's meet waves;
backends without one use that shared solver.

Backends that shard over a device mesh set ``needs_mesh`` and receive the
engine's ``mesh`` (``repro_torch.launch.mesh.Mesh``) as a keyword.
``donate_args`` is kept for the registry's shape and has no effect: it
asked XLA to alias input buffers.  ``dispatch(fn, *arrays)`` intercepts
each call.

Built-ins (all serve every penalty model and heuristic):

* ``"ref"``    — full-history WFA in plain PyTorch; pointer-chase CIGAR
                 traceback over the ``[s_max+1, B, K]`` history
* ``"ring"``   — rolling-window WFA in plain PyTorch; packed backtrace
* ``"kernel"`` — the CUDA WFA kernel (its plain version on CPU tensors);
                 packed backtrace OR-accumulated in registers, decoded into
                 CIGAR ops by the CUDA traceback kernel on a card; the CUDA
                 meet kernel as its meet variant
* ``"shardmap"`` — the ring solver per mesh shard (per-shard termination,
                 zero collectives: the paper's "no inter-DPU
                 communication"); trace variant runs the packed solver per
                 shard
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core import wavefront as wf

ALL_MODELS = ("affine", "linear")


def _accepts_kw(fn: Optional[Callable], kw: str) -> bool:
    """True when ``fn`` takes keyword ``kw`` (or ``**kwargs``)."""
    if fn is None:
        return False
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return True
    if kw in sig.parameters:
        return True
    return any(p.kind is inspect.Parameter.VAR_KEYWORD
               for p in sig.parameters.values())


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    name: str
    fn: Callable[..., wf.WFAResult]
    trace_variant: Optional[Callable[..., wf.WFAResult]] = None
    meet_variant: Optional[Callable] = None
    needs_mesh: bool = False
    donate_args: Tuple[int, ...] = ()
    dispatch: Optional[Callable[..., wf.WFAResult]] = None
    models: Tuple[str, ...] = ("affine",)
    doc: str = ""

    @property
    def supports_cigar(self) -> bool:
        return self.trace_variant is not None

    def supports_model(self, kind: str) -> bool:
        return kind in self.models

    def accepts_heuristic(self, output: str = "score") -> bool:
        """Whether the callable serving ``output`` takes ``heur=``."""
        return _accepts_kw(self.fn if output == "score"
                           else self.trace_variant, "heur")

    def callables(self) -> Tuple[Callable, ...]:
        """Every non-None solver callable (the engine validates
        ``backend_opts`` keys against them)."""
        return tuple(f for f in (self.fn, self.trace_variant,
                                 self.meet_variant) if f is not None)

    def accepts_states(self) -> bool:
        """Whether the trace variant takes ``begin_state``/``end_state``."""
        return _accepts_kw(self.trace_variant, "begin_state")

    def variant(self, output: str,
                model_kind: str = "affine") -> Callable[..., wf.WFAResult]:
        """The callable serving one output mode under one model kind."""
        if model_kind not in self.models:
            raise ValueError(
                f"backend {self.name!r} serves penalty models "
                f"{self.models}; {model_kind!r} models need one of: "
                f"{model_backends(model_kind)}")
        if output == "score":
            return self.fn
        if output == "cigar":
            if self.trace_variant is None:
                raise ValueError(
                    f"backend {self.name!r} is score-only (no trace "
                    f"variant); CIGAR-capable backends: "
                    f"{cigar_backends()}")
            return self.trace_variant
        raise ValueError(f"unknown output mode {output!r}; "
                         "use 'score' or 'cigar'")


_REGISTRY: Dict[str, BackendSpec] = {}


def register_backend(name: str, fn: Optional[Callable] = None, *,
                     trace_variant: Optional[Callable] = None,
                     meet_variant: Optional[Callable] = None,
                     needs_mesh: bool = False,
                     donate_args: Tuple[int, ...] = (),
                     dispatch: Optional[Callable] = None,
                     models: Tuple[str, ...] = ("affine",),
                     doc: str = ""):
    """Register an alignment backend (usable as a decorator); a name that
    is registered again replaces the earlier entry."""
    def _add(f):
        _REGISTRY[name] = BackendSpec(name=name, fn=f,
                                      trace_variant=trace_variant,
                                      meet_variant=meet_variant,
                                      needs_mesh=needs_mesh,
                                      donate_args=tuple(donate_args),
                                      dispatch=dispatch,
                                      models=tuple(models),
                                      doc=doc or (f.__doc__ or "").strip())
        return f

    if fn is not None:
        return _add(fn)
    return _add


def unregister_backend(name: str) -> None:
    _REGISTRY.pop(name, None)


def get_backend(name: str) -> BackendSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown alignment backend {name!r}; "
                       f"available: {available_backends()}") from None


def available_backends() -> List[str]:
    return sorted(_REGISTRY)


def cigar_backends() -> List[str]:
    """Backends with a trace variant (serve ``output='cigar'``)."""
    return sorted(n for n, s in _REGISTRY.items() if s.supports_cigar)


def model_backends(kind: str) -> List[str]:
    """Backends serving penalty models of recurrence ``kind``."""
    return sorted(n for n, s in _REGISTRY.items() if s.supports_model(kind))


# ---------------------------------------------------------------------------
# Built-in backends.


def _ref_trace(pattern, text, plen, tlen, *, pen, s_max, k_max, heur=None,
               begin_state="M", end_state="M"):
    return wf.wfa_forward(pattern, text, plen, tlen, pen=pen, s_max=s_max,
                          k_max=k_max, keep_history=True, heur=heur,
                          begin_state=begin_state, end_state=end_state,
                          device=pattern.device)


@register_backend("ref", trace_variant=_ref_trace, models=ALL_MODELS,
                  doc="full-history WFA in plain PyTorch; full-history "
                      "CIGAR traceback")
def _ref_backend(pattern, text, plen, tlen, *, pen, s_max, k_max, heur=None):
    return wf.wfa_forward(pattern, text, plen, tlen, pen=pen, s_max=s_max,
                          k_max=k_max, keep_history=False, heur=heur,
                          device=pattern.device)


def _ring_trace(pattern, text, plen, tlen, *, pen, s_max, k_max, heur=None,
                begin_state="M", end_state="M", band_cap=None):
    return wf.wfa_scores_packed(pattern, text, plen, tlen, pen=pen,
                                s_max=s_max, k_max=k_max, heur=heur,
                                begin_state=begin_state, end_state=end_state,
                                band_cap=band_cap, device=pattern.device)


@register_backend("ring", donate_args=(2, 3), trace_variant=_ring_trace,
                  models=ALL_MODELS,
                  doc="rolling-window WFA in plain PyTorch; packed "
                      "backtrace")
def _ring_backend(pattern, text, plen, tlen, *, pen, s_max, k_max, heur=None,
                  band_cap=None):
    return wf.wfa_scores(pattern, text, plen, tlen, pen=pen, s_max=s_max,
                         k_max=k_max, heur=heur, band_cap=band_cap,
                         device=pattern.device)


def _kernel_trace(pattern, text, plen, tlen, *, pen, s_max, k_max,
                  heur=None, block_pairs=None, gather=None, ext_stride=1,
                  band_cap=None):
    """On a card the traceback kernel decodes the planes where the trace
    kernel left them, and the result carries the ops (``ops``, ``n_ops``,
    ``status``) instead of the planes; on the CPU, the planes."""
    from repro_torch.kernels.wfa import ops as kops
    if pattern.device.type == "cuda":
        score, ops, n_ops, status, held = kops.wfa_align_cigar(
            pattern, text, plen, tlen, pen=pen, s_max=s_max, k_max=k_max,
            heur=heur, block_pairs=block_pairs, band_cap=band_cap,
            device=pattern.device)
        return wf.WFAResult(score, None, None, None, int(s_max), ops=ops,
                            n_ops=n_ops, status=status, plane_nbytes=held)
    score, m_bt, i_bt, d_bt = kops.wfa_align_trace(
        pattern, text, plen, tlen, pen=pen, s_max=s_max, k_max=k_max,
        heur=heur, block_pairs=block_pairs, band_cap=band_cap,
        device=pattern.device)
    return wf.WFAResult(score, None, None, None, int(s_max), m_bt, i_bt,
                        d_bt)


def _kernel_meet(pattern, text, plen, tlen, starget, *, pen, s_max, k_max,
                 heur=None, begin_state="M", end_state="M",
                 block_pairs=None):
    from repro_torch.kernels.wfa import ops as kops
    return kops.wfa_bidir_meet_kernel(
        pattern, text, plen, tlen, starget, pen=pen, s_max=s_max,
        k_max=k_max, heur=heur, begin_state=begin_state,
        end_state=end_state, block_pairs=block_pairs, device=pattern.device)


@register_backend("kernel", donate_args=(2, 3), trace_variant=_kernel_trace,
                  meet_variant=_kernel_meet, models=ALL_MODELS,
                  doc="hand-written CUDA WFA kernel (plain PyTorch on CPU "
                      "tensors); packed backtrace; CUDA BiWFA meet")
def _kernel_backend(pattern, text, plen, tlen, *, pen, s_max, k_max,
                    heur=None, block_pairs=None, gather=None, ext_stride=1,
                    band_cap=None):
    from repro_torch.kernels.wfa import ops as kops
    score = kops.wfa_align(pattern, text, plen, tlen, pen=pen, s_max=s_max,
                           k_max=k_max, heur=heur, block_pairs=block_pairs,
                           band_cap=band_cap, device=pattern.device)
    return wf.WFAResult(score, None, None, None, int(s_max))


def _shardmap_trace(pattern, text, plen, tlen, *, pen, s_max, k_max, mesh,
                    heur=None, band_cap=None):
    score, m_bt, i_bt, d_bt = wf.wfa_trace_shardmap(
        pattern, text, plen, tlen, pen=pen, s_max=s_max, k_max=k_max,
        mesh=mesh, heur=heur, band_cap=band_cap)
    return wf.WFAResult(score, None, None, None, int(s_max), m_bt, i_bt,
                        d_bt)


@register_backend("shardmap", needs_mesh=True, trace_variant=_shardmap_trace,
                  models=ALL_MODELS,
                  doc="ring solver per mesh shard: per-shard termination, "
                      "zero collectives; per-shard packed backtrace")
def _shardmap_backend(pattern, text, plen, tlen, *, pen, s_max, k_max, mesh,
                      heur=None, band_cap=None):
    score = wf.wfa_scores_shardmap(pattern, text, plen, tlen, pen=pen,
                                   s_max=s_max, k_max=k_max, mesh=mesh,
                                   heur=heur, band_cap=band_cap)
    return wf.WFAResult(score, None, None, None, int(s_max))

"""Batched WFA pairwise alignment on PyTorch: scoring models, the ring
solvers, the backend registry, the engine and its streaming session."""
from repro_torch.core.penalties import (DEFAULT, Penalties,  # noqa: F401
                                        band_bound, problem_dims,
                                        score_bound)
from repro_torch.core.scoring import (AdaptiveBand, Edit,  # noqa: F401
                                      GapAffine, GapLinear, NoHeuristic,
                                      PenaltyModel, WavefrontHeuristic,
                                      ZDrop, as_heuristic, as_model,
                                      from_reference, parse_heuristic,
                                      parse_penalties)
from repro_torch.core.wavefront import (WFAResult, wfa_scores,  # noqa: F401
                                        wfa_scores_packed)
from repro_torch.core.backends import (available_backends,  # noqa: F401
                                       cigar_backends, get_backend,
                                       register_backend)
from repro_torch.core.cigar import (TracebackError,  # noqa: F401
                                    cigar_identity, cigar_string)
from repro_torch.core.engine import (AlignmentEngine,  # noqa: F401
                                     EngineResult, EngineStats, PIMStats,
                                     encode, pack_batch, problem_bounds)
from repro_torch.core.session import (AlignmentSession,  # noqa: F401
                                      SessionStats, Ticket)
from repro_torch.core.gotoh import (gotoh_score, gotoh_score_vec,  # noqa: F401
                                    score_cigar)

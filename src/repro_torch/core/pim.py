"""PIM-style distributed batch executor — compatibility shim.

.. deprecated::
    The scatter -> align -> gather pipeline, wave chunking and the Fig. 1
    phase accounting live in :class:`repro_torch.core.engine.
    AlignmentEngine`.  ``PIMBatchAligner`` wraps an engine and returns the
    familiar ``(scores, PIMStats)`` tuple, as in the JAX package.

Paper mapping: one host thread scatters read pairs over the device mesh
(``repro_torch.launch.mesh.Mesh``), the pair axis spread over every mesh
axis; the devices align independently (the ``shardmap`` backend shares
nothing between shards); the host gathers the results.  *Total* and
*Kernel* throughput are reported as in Fig. 1.
"""
from __future__ import annotations

import warnings
from typing import Optional, Sequence

from repro_torch.core.aligner import WFAligner, pack_batch
from repro_torch.core.engine import (AlignmentEngine, PIMStats,  # noqa: F401
                                     pair_sharding)
from repro_torch.launch.mesh import Mesh

__all__ = ["PIMBatchAligner", "PIMStats", "pair_sharding"]


class PIMBatchAligner:
    """Scatter -> align -> gather over a device mesh (session-backed).

    ``chunk_pairs`` bounds device memory per wave (the MRAM-capacity
    analogue); large batches stream in waves.  ``run_arrays`` is one
    blocking pass through an :class:`~repro_torch.core.session.
    AlignmentSession`.
    """

    def __init__(self, aligner: WFAligner, mesh: Optional[Mesh] = None,
                 chunk_pairs: int = 1 << 16, penalties=None):
        warnings.warn(
            "PIMBatchAligner is deprecated; use repro_torch.core.engine."
            "AlignmentEngine (blocking align()) or AlignmentEngine.stream() "
            "/ repro_torch.core.session.AlignmentSession (pipelined "
            "submission)", DeprecationWarning, stacklevel=2)
        self.aligner = aligner
        self.mesh = mesh
        self.chunk_pairs = chunk_pairs
        pen = aligner.pen
        if penalties is not None:
            # the engine-era spelling: accepted with a warning, not refused
            warnings.warn(
                "PIMBatchAligner(penalties=...) is the AlignmentEngine "
                "spelling; forwarding it as this executor's penalty model "
                "(gap-affine triples map to scoring.GapAffine)",
                DeprecationWarning, stacklevel=2)
            pen = penalties
        if mesh is None and penalties is None:
            # reuse the aligner's engine and its warm cache; this
            # executor's per-wave cap applies through the session
            self._engine = aligner.engine
        else:
            # on a mesh the engine runs on its first device, else where
            # the aligner runs
            self._engine = AlignmentEngine(
                pen, backend=aligner.backend, edit_frac=aligner.edit_frac,
                s_max=aligner._s_max, k_max=aligner._k_max, mesh=mesh,
                chunk_pairs=chunk_pairs,
                device=None if mesh is not None else aligner.engine.device)
        self.n_workers = self._engine.n_workers

    @property
    def engine(self) -> AlignmentEngine:
        return self._engine

    def run(self, patterns: Sequence, texts: Sequence):
        p, plen = pack_batch(patterns)
        t, tlen = pack_batch(texts)
        return self.run_arrays(p, plen, t, tlen)

    def run_arrays(self, p, plen, t, tlen):
        from repro_torch.core.session import AlignmentSession
        sess = AlignmentSession(self._engine, max_inflight_waves=1,
                                wave_pairs=int(self.chunk_pairs),
                                _sync_timing=True)
        ticket = sess.submit_packed(p, plen, t, tlen)
        sess.drain()
        res = ticket.result()
        return res.scores, res.stats.pim

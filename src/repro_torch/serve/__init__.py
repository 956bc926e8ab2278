"""repro_torch.serve — the always-on alignment service on the port.

Continuous batching over the streaming engine, the counterpart of
``repro.serve``: a bounded :class:`RequestQueue` (admission control +
load shedding), a :class:`WaveFormer` (deadline-or-full wave formation
with length-bucket affinity), and a :class:`ServeLoop` whose worker
threads feed one shared :class:`~repro_torch.core.session.AlignmentSession`
and deliver out-of-order completions to per-request futures.  On the
``kernel`` backend every score wave runs the CUDA score kernel and every
CIGAR wave the trace kernel.  ``launch/serve_align.py`` is the CLI.
"""
from repro_torch.serve.driver import ReplayReport, replay_trace
from repro_torch.serve.loop import ServeLoop, ServerStats
from repro_torch.serve.queue import RequestQueue
from repro_torch.serve.request import (AlignFuture, AlignRequest,
                                       AlignResult, ShedError)
from repro_torch.serve.waves import FormedWave, WaveFormer, WaveSlice

__all__ = [
    "AlignFuture", "AlignRequest", "AlignResult", "FormedWave",
    "ReplayReport", "RequestQueue", "ServeLoop", "ServerStats", "ShedError",
    "WaveFormer", "WaveSlice", "replay_trace",
]

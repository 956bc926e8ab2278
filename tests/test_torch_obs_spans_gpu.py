"""Each wave's device seconds by CUDA events against the profiler's own
timeline of the same waves, on the card.

It imports no JAX, so it runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -s -m gpu tests/test_torch_obs_spans_gpu.py

Without a card it skips.  The waves run under the profiler, and each
event interval is held against the device work the profiler shows in it:
``t_dev_copy_in`` (events around the copies in, recorded after the host
has staged them) against the ``Memcpy HtoD`` time, ``t_dev_kernel``
(events each launch records right around its kernel) against the WFA
kernels' time, ``t_dev_traceback`` (the traceback kernel's own events) in
the CIGAR cases against that kernel's time, ``t_dev_copy_out`` against the
``Memcpy DtoH`` time.  A CIGAR wave's trace is decoded on the card: every
pair counts in ``n_tb_card``, and the profile holds no ``traceback.walk``
or ``traceback.replay`` span.

Where the card's work outlasts the host's enqueues (10 kb waves: copies of
1.5 ms, a kernel of 7 ms), copy in and kernel agree with the profiler
within 10%.  Where the host is slower than the card (100 bp waves: copies
of 40 us to 1.2 ms, kernels of 40 us to 0.4 ms, against an enqueue of
tens of us under the profiler), the card reaches each mark before the
host has enqueued the next operation, so an interval also holds that wait
and the operation's own start-up: it is held between the device work and
that work plus ``ENQUEUE_S`` for each operation.  As in the benchmark, the
profiler's first start in the process, and its first sight of each
kernel, come before the measured waves.

Two kinds of case: one wave at a time (a 10 kb score wave; eight 100 bp
trace waves, so that one stall of the host between two marks, up to a
millisecond under the profiler, stays inside the bound), and each
benchmark cell's own traffic (chunk, waves outstanding) streamed over
several chunks, the intervals summed over the waves.
"""
import collections
import json
import os
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.engine import AlignmentEngine  # noqa: E402
from repro_torch.core.scoring import GapAffine  # noqa: E402
from repro_torch.data.reads import ReadPairSpec, generate_pairs  # noqa: E402
from repro_torch.obs import profile as obs_profile  # noqa: E402

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

# case -> (pairs a chunk, read length, edits, output, waves outstanding,
# chunks, whether the card outpaces the host); the stream-* cases are the
# benchmark cells' traffic
CASES = {
    "wave-score-10kb": (1024, 10_000, 0.03, "score", 1, 1, False),
    "wave-trace-100bp": (4096, 100, 0.02, "cigar", 1, 8, True),
    "stream-score-100bp": (65536, 100, 0.02, "score", 4, 8, True),
    "stream-score-10kb": (1024, 10_000, 0.03, "score", 2, 4, False),
    "stream-cigar-100bp": (4096, 100, 0.02, "cigar", 4, 16, True),
}
# the card's wait for one host enqueue under the profiler, and the
# operation's start-up, at most (H100: 12 to 27 us an operation)
ENQUEUE_S = 50e-6
COPIES_IN = 4                    # patterns, texts and both lengths


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _device_seconds(path):
    """-> seconds of the profiled device work: ``htod`` and ``dtoh`` (the
    copies), ``kernel`` (the WFA kernels) and ``traceback`` (the traceback
    kernel), and the names of the program's spans in the profile."""
    with open(os.path.join(path, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    dev = [(float(e["dur"]), e["name"]) for e in events
           if e.get("ph") == "X"
           and str(e.get("cat", "")).lower() in DEVICE_CATS]
    tb = lambda n: "wfa_traceback_kernel" in n
    return {"htod": sum(d for d, n in dev if "HtoD" in n) / 1e6,
            "dtoh": sum(d for d, n in dev if "DtoH" in n) / 1e6,
            "kernel": sum(d for d, n in dev
                          if re.search(r"wfa_\w*_kernel<", n)
                          and not tb(n)) / 1e6,
            "traceback": sum(d for d, n in dev if tb(n)) / 1e6,
            "spans": {e["name"] for e in events
                      if e.get("cat") == "user_annotation"}}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_wave_events_agree_with_the_profiler(cuda_device, tmp_path, case):
    n, L, E, output, outstanding, chunks, host_bound = CASES[case]
    P, plen, T, tlen = generate_pairs(ReadPairSpec(n_pairs=n, read_len=L,
                                                   edit_frac=E, seed=31))
    eng = AlignmentEngine(GapAffine(4, 6, 2), backend="kernel",
                          edit_frac=E, chunk_pairs=n,
                          backend_opts={"block_pairs": 8},
                          device=cuda_device)

    def closed_loop(k):
        """k chunks, ``outstanding`` at a time, as the benchmark submits."""
        with eng.stream(max_inflight_waves=outstanding) as sess:
            pending = collections.deque()
            for _ in range(k):
                if len(pending) >= outstanding:
                    pending.popleft().result()
                pending.append(sess.submit_packed(P, plen, T, tlen,
                                                  output=output))
            while pending:
                pending.popleft().result()
        return sess.stats

    closed_loop(1)                   # build, load and warm outside
    with obs_profile.profile(str(tmp_path / "warm")):
        closed_loop(1)
    torch.cuda.synchronize()
    with obs_profile.profile(str(tmp_path / "run")):
        st = closed_loop(chunks)
        torch.cuda.synchronize()
    prof = _device_seconds(str(tmp_path / "run"))
    assert st.n_waves == chunks and st.n_overflow == 0

    def ms(*secs):
        return ", ".join(f"{x * 1e3:.4f}" for x in secs)

    print(f"\n[{case}] {torch.cuda.get_device_name(0)}, ms of copy in, "
          f"kernel, copy out: events "
          f"{ms(st.t_dev_copy_in, st.t_dev_kernel, st.t_dev_copy_out)}; "
          f"profiler {ms(prof['htod'], prof['kernel'], prof['dtoh'])}")
    pairs = [(st.t_dev_copy_in, prof["htod"], COPIES_IN),
             (st.t_dev_kernel, prof["kernel"], 1)]
    if output == "cigar":
        print(f"[{case}] traceback kernel ms: events "
              f"{ms(st.t_dev_traceback)}; profiler {ms(prof['traceback'])}")
        assert (st.n_tb_card, st.n_tb_host) == (n * chunks, 0)
        assert "wave.traceback" in prof["spans"]
        assert not prof["spans"] & {"traceback.walk", "traceback.replay"}
        assert prof["traceback"] > 0
        pairs.append((st.t_dev_traceback, prof["traceback"], 1))
    else:
        assert st.t_dev_traceback == prof["traceback"] == 0
    for events, work, ops in pairs:
        if host_bound:
            assert work <= events <= work + ops * chunks * ENQUEUE_S
        else:
            assert events == pytest.approx(work, rel=0.10)
    assert st.t_dev_copy_out >= prof["dtoh"]

"""The alignment cells: a closed loop over one ``engine.stream()`` session.

The workload file gives the traffic (read length, E, the edit mix, the
pool) and the loop (pairs a chunk, chunks kept outstanding, waves in
flight, the output).  Set-up makes the pool from the seed, builds the
engine the configuration file describes and sends one chunk of the cell's
own shape.  The window then keeps ``outstanding`` chunks submitted with
``submit_packed`` and gathers them with ``as_completed()``, as
``core/session.py::run_streamed`` does, submitting the next chunk of the
pool (cycled) each time one completes, until ``seconds`` have passed; the
chunks still out are then drained.  Once the window has closed, a sample
of whole chunks drawn from the seed (and, in a traced run, the chunks
whose kernels the profiled slice timed) is judged against the reference.
"""
from __future__ import annotations

import contextlib
import os
import re
import shutil
import tempfile
import time
import traceback
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np

from harness import devtrace, gen, reference, work

# a traced run profiles the last seconds of its window: long enough to
# hold some chunks of every cell, short enough for a trace of a few MB
SLICE_SECONDS = 5.0

# the full-width WFA kernel, csrc/wfa.cu: wfa_full_kernel<AFFINE, TRACE, H>
_KERNEL_RE = re.compile(r"wfa_full_kernel<\s*(\w+)\s*,\s*(\w+)")


def kernel_kind(name: str) -> Optional[str]:
    """"score" / "trace" for the full-width WFA kernel, else None."""
    m = _KERNEL_RE.search(name)
    if m is None:
        return None
    return "trace" if m.group(2) in ("true", "1") else "score"


class _Chunk:
    __slots__ = ("cid", "lo", "n", "t_sub", "t_done", "result")

    def __init__(self, cid, lo, n, t_sub):
        self.cid, self.lo, self.n, self.t_sub = cid, lo, n, t_sub
        self.t_done = None
        self.result = None


def _engine(cfg: dict, wl: dict, device: str):
    from repro_torch.core import scoring
    from repro_torch.core.engine import AlignmentEngine
    pen = cfg["penalties"]
    return AlignmentEngine(
        scoring.GapAffine(pen["x"], pen["o"], pen["e"]),
        backend=cfg["backend"], edit_frac=wl["edit_frac"],
        heuristic=scoring.parse_heuristic(cfg["heuristic"]),
        chunk_pairs=cfg["wave_pairs"],
        backend_opts={"block_pairs": cfg["block_pairs"]},
        trace_budget=cfg.get("trace_budget"), device=device)


def run(cell: dict, seed: int, seconds: float, trace: bool, device: str,
        t_proc: float) -> SimpleNamespace:
    """One run of an alignment cell -> the harness's record of it (what
    the metric readers get as ``run``)."""
    import torch
    from repro_torch.obs import profile as obs_profile
    from repro_torch.obs import trace as obs_trace

    cfg, wl = cell["config"], cell["workload"]
    cuda = device.startswith("cuda")
    pen = cfg["penalties"]
    x, o, e = pen["x"], pen["o"], pen["e"]
    chunk, pool = int(wl["chunk_pairs"]), int(wl["pool_pairs"])
    if pool % chunk:
        raise ValueError("the pool must hold whole chunks")
    n_pool_chunks = pool // chunk
    P, plen, T, tlen, _ = gen.generate_pool(pool, wl["read_len"],
                                            wl["edit_frac"], wl["mix"], seed,
                                            block=chunk)
    chunk_bases = (plen.astype(np.int64) + tlen).reshape(
        n_pool_chunks, chunk).sum(axis=1)
    out_mode = wl["output"]
    tv = wl.get("trace_variant", "packed")
    engine = _engine(cfg, wl, device)

    def rows(c):
        lo = (c % n_pool_chunks) * chunk
        return lo, slice(lo, lo + chunk)

    # set-up: one chunk of the cell's own shape
    with engine.stream(max_inflight_waves=wl["max_inflight_waves"]) as ws:
        _, sl = rows(0)
        ws.submit_packed(P[sl], plen[sl], T[sl], tlen[sl], output=out_mode,
                         trace_variant=tv).result()
    if trace:
        # the profiler's first start sets up its device tracing: in set-up
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts):
            torch.ones(1, device=device).add_(1)
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()

    sess = engine.stream(max_inflight_waves=wl["max_inflight_waves"])
    chunks: Dict[int, _Chunk] = {}
    state = SimpleNamespace(next=1, bases=0, prof=None, profiling=False)
    prof_dir = tempfile.mkdtemp(prefix="bench-trace-") if trace else None
    slice_s = min(SLICE_SECONDS, seconds / 2)
    if trace:
        obs_trace.reset()
        obs_trace.enable()

    def submit():
        c = state.next
        state.next += 1
        lo, sl = rows(c)
        t = time.perf_counter()
        ann = (torch.profiler.record_function(f"bench.submit#{c}")
               if state.profiling else contextlib.nullcontext())
        with ann:
            tk = sess.submit_packed(P[sl], plen[sl], T[sl], tlen[sl],
                                    output=out_mode, trace_variant=tv)
        chunks[tk.index] = _Chunk(c, lo, chunk, t)
        state.bases += int(chunk_bases[c % n_pool_chunks])

    def start_profile():
        stack = contextlib.ExitStack()
        stack.enter_context(obs_profile.profile(prof_dir))
        with obs_trace.span("bench.clock", cat="bench"), \
                torch.profiler.record_function("bench.clock"):
            pass
        stack.enter_context(torch.profiler.record_function("bench.slice"))
        state.prof, state.profiling = stack, True

    def stop_profile():
        state.profiling = False
        state.prof.close()

    t0 = time.perf_counter()
    with obs_trace.span("bench.start", cat="bench"):
        pass
    t_end = t0 + seconds
    missing = errors = 0
    try:
        for _ in range(int(wl["outstanding"])):
            submit()
        for tk in sess.as_completed(timeout=seconds + 60):
            now = time.perf_counter()
            ch = chunks[tk.index]
            ch.t_done, ch.result = now, tk.result()
            if now < t_end:
                if trace and state.prof is None and now >= t_end - slice_s:
                    start_profile()
                submit()
            elif state.profiling:
                stop_profile()
    except Exception:
        # the session failed or timed out: the answers still out never come
        traceback.print_exc()
        errors = 1
        missing = sum(1 for ch in chunks.values() if ch.t_done is None)
    if state.profiling:
        stop_profile()
    if trace:
        obs_trace.disable()
        events = obs_trace.events()
        obs_trace.reset()
    peak_window = torch.cuda.max_memory_allocated() if cuda else 0
    stats = sess.stats
    del sess
    if cuda:
        torch.cuda.empty_cache()

    done = [ch for ch in chunks.values() if ch.t_done is not None]
    in_window = [ch for ch in done if ch.t_done <= t_end]
    attempted = sum(1 for ch in chunks.values() if ch.t_sub < t_end)
    unresolved = sum(int(np.sum(ch.result.scores < 0)) for ch in done)
    failed = missing + sum(1 for ch in done
                           if np.any(ch.result.scores < 0))

    rec = SimpleNamespace(
        cell=cell, seed=seed, seconds=seconds, x=x, o=o, e=e,
        window_pairs=sum(ch.n for ch in in_window),
        latencies_s=np.array([ch.t_done - ch.t_sub for ch in in_window]),
        setup_s=t0 - t_proc, peak_window_bytes=peak_window,
        memory_peak_bytes=max(setup_peak, peak_window) if cuda else 0,
        stats=stats, bases_in=state.bases, attempted=attempted,
        failed=failed, dev=None, launches=[], spans=None, breakdown=None,
        ref_scores={})

    # the device timeline of the profiled slice
    judged_extra: List[_Chunk] = []
    if trace:
        obs_a = next(ev["ts"] for ev in events if ev["name"] == "bench.start")
        rec.spans = {"events": events, "a": obs_a,
                     "b": obs_a + seconds * 1e6}
        path = os.path.join(prof_dir, "trace.json")
        if os.path.exists(path):
            dt = devtrace.DeviceTrace.load(path)
            _read_slice(rec, dt, events, chunks, wl, judged_extra)
        shutil.rmtree(prof_dir, ignore_errors=True)

    # judge a sample of whole chunks drawn from the seed
    rng = np.random.default_rng([seed, 7])
    pick = rng.choice(len(done), size=min(int(wl["judge_chunks"]), len(done)),
                      replace=False)
    judged = {ch.cid: ch for ch in [done[i] for i in pick] + judged_extra}
    checks = _judge(rec, list(judged.values()), P, plen, T, tlen, device,
                    out_mode == "cigar", int(wl["judge_chunks"]) * chunk)
    checks["unresolved"] = {"value": unresolved, "limit": 0, "rule": "<="}
    checks["missing"] = {"value": missing, "limit": 0, "rule": "<="}
    checks["errors"] = {"value": errors, "limit": 0, "rule": "<="}
    rec.checks = checks
    return rec


def _read_slice(rec, dt, events, chunks, wl, judged_extra) -> None:
    """Kernels, busy time and idle gaps of the profiled slice."""
    sl = dt.annotation("bench.slice")
    clock = dt.annotation("bench.clock")
    if sl is None or clock is None:
        return
    a, b = sl
    rec.dev = {"busy_s": float(np.sum(np.diff(dt.busy_intervals(a, b))))
               / 1e6, "window_s": (b - a) / 1e6}
    # each kernel's chunk: the submit annotation its launch lies in
    subs = sorted((ev["ts"], ev["ts"] + ev["dur"], int(ev["name"][13:]))
                  for ev in dt.annotations
                  if ev["name"].startswith("bench.submit#"))
    starts = np.array([s[0] for s in subs])
    by_cid = {ch.cid: ch for ch in chunks.values()}
    for k in dt.kernels(a, b):
        cid = None
        if k["launch_ts"] is not None and len(subs):
            i = int(np.searchsorted(starts, k["launch_ts"], "right")) - 1
            if i >= 0 and k["launch_ts"] <= subs[i][1]:
                cid = subs[i][2]
        rec.launches.append({"name": k["name"], "kind": kernel_kind(k["name"]),
                             "seconds": k["dur"] / 1e6, "chunk": cid})
    mapped = [k for k in rec.launches
              if k["kind"] is not None and k["chunk"] in by_cid
              and by_cid[k["chunk"]].t_done is not None]
    n_roof = int(wl.get("roofline_launches", 0))
    for k in mapped[len(mapped) - min(n_roof, len(mapped)):]:
        judged_extra.append(by_cid[k["chunk"]])
    # idle gaps, each labelled by the program's innermost span around it
    off = clock[0] - next(ev["ts"] for ev in events
                          if ev["name"] == "bench.clock")
    spans = [(ev["ts"] + off, ev["ts"] + ev.get("dur", 0.0) + off, ev["name"])
             for ev in events if ev.get("ph") == "X"]
    gaps = dt.idle_gaps(a, b)
    labels = devtrace.label_times(gaps.mean(axis=1), spans)
    idle: Dict[str, float] = {}
    for (g0, g1), lab in zip(gaps, labels):
        lab = lab or "no span"
        idle[lab] = idle.get(lab, 0.0) + (g1 - g0) / 1e6
    rec.breakdown = {
        "device_ops": [[n, s] for n, s in dt.op_seconds(a, b)[:10]],
        "idle_gaps": sorted(([n, s] for n, s in idle.items()),
                            key=lambda kv: -kv[1])[:10]}


def _judge(rec, judged: List[_Chunk], P, plen, T, tlen, device: str,
           cigar: bool, min_pairs: int) -> dict:
    """Reference scores of the judged chunks, and the counts of wrong
    answers in them."""
    idx = (np.concatenate([np.arange(ch.lo, ch.lo + ch.n) for ch in judged])
           if judged else np.zeros(0, np.int64))
    ref = reference.gotoh_scores(P[idx], plen[idx], T[idx], tlen[idx],
                                 rec.x, rec.o, rec.e, device=device)
    got = (np.concatenate([ch.result.scores for ch in judged])
           if judged else np.zeros(0, np.int32))
    cigars = ([c for ch in judged for c in ch.result.cigars]
              if cigar else None)
    bad = reference.check_pairs(got, ref, cigars, P[idx], plen[idx], T[idx],
                                tlen[idx], rec.x, rec.o, rec.e)
    pos = 0
    for ch in judged:
        rows = slice(ch.lo, ch.lo + ch.n)
        rec.ref_scores[ch.cid] = (ref[pos:pos + ch.n], plen[rows], tlen[rows])
        pos += ch.n
    out = {name: {"value": v, "limit": 0, "rule": "<="}
           for name, v in bad.items()}
    out["pairs_judged"] = {"value": int(idx.size), "limit": min_pairs,
                           "rule": ">="}
    return out


def kernel_roofline(rec, kind: str):
    """% of its roofline that the ``kind`` kernel ("score" / "trace") ran
    at over the profiled slice's launches of judged chunks: the work
    those chunks need at least (``work.py``) over the launches' device
    seconds; None where the slice timed none."""
    secs: Dict[int, float] = {}
    for k in rec.launches:
        if k["kind"] == kind and k["chunk"] in rec.ref_scores:
            secs[k["chunk"]] = secs.get(k["chunk"], 0.0) + k["seconds"]
    if not secs:
        return None
    n_bytes, n_ops = chunk_work(rec, secs, kind == "trace")
    return work.roofline_pct(n_bytes, n_ops, sum(secs.values()))


def chunk_work(rec, cids, trace: bool):
    """(bytes, operations) the judged chunks ``cids`` need at least."""
    n_bytes = n_ops = 0
    for cid in cids:
        ref, pl, tl = rec.ref_scores[cid]
        n_bytes += work.wave_bytes(pl, tl, trace)
        n_ops += int(work.wavefront_ops(ref, pl, tl, rec.x, rec.o,
                                        rec.e).sum())
    return n_bytes, n_ops

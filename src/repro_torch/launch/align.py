"""Alignment launcher — the paper's pipeline end to end, on the card.

Generates the paper's workload (read pairs at edit threshold E) and streams
it through :meth:`AlignmentEngine.stream`: read-pair chunks are submitted
as they are produced, host-side packing of the next wave overlaps the
in-flight kernel, and results are gathered out of order.  ``--mode sync``
runs the blocking ``align()`` path instead; ``--mode both`` runs the two
back to back.  Throughput is reported both ways the paper does: *Total*
(with host<->device transfers) and *Kernel* (alignment only).

    python -m repro_torch.launch.align --backend kernel --pairs 65536 \\
        --chunk-pairs 65536 --verify 512            # on the card
    python -m repro_torch.launch.align --device cpu --pairs 64 --verify 8

``--backend ref|ring|kernel|shardmap`` selects a registered backend
(``repro_torch.core.backends``; ``shardmap`` splits each wave over every
visible card, or runs one shard on ``--device``); ``--output
score|cigar|sam`` the result pathway (``cigar``: full alignments, with
identity stats; ``sam``: the same plus one SAM record per pair, written to
``--sam-out``, default stdout, where the mutated mate (*text*) is the read
and the sampled reference read (*pattern*) its reference); ``--trace
packed|bidir`` how CIGARs are made: the packed backtrace, or the BiWFA
meet-in-the-middle recursion (``repro_torch.biwfa``: exact CIGARs in O(s)
trace memory, for noisy long reads)::

    python -m repro_torch.launch.align --backend kernel --output cigar \\
        --trace bidir --pairs 1024 --read-len 10000 --edit-frac 0.03 \\
        --verify 4

``--penalties``/``--heuristic`` the scoring model and
wavefront pruning; ``--reads``/``--refs`` real FASTA/FASTQ(.gz) pair files
in place of the synthetic generator; ``--device`` where the waves run
(default ``cuda``).
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import numpy as np

from repro_torch import obs
from repro_torch.configs import wfa_paper
from repro_torch.core import cigar as cigar_mod
from repro_torch.core import scoring
from repro_torch.core.backends import available_backends, get_backend
from repro_torch.core.engine import AlignmentEngine
from repro_torch.core.gotoh import gotoh_score_vec, score_cigar
from repro_torch.core.session import run_streamed
from repro_torch.data.io import load_pair_files
from repro_torch.data.reads import ReadPairSpec, generate_pairs


def _run_sync(engine, P, plen, T, tlen, output):
    t0 = time.perf_counter()
    with obs.trace.span("align.sync", cat="align"):
        res = engine.align_packed(P, plen, T, tlen, output=output)
    return res.scores, res.cigars, res.stats, time.perf_counter() - t0


def write_sam(out, scores, cigars, plen, T, tlen, cl=None) -> None:
    """Full SAM stream via the shared ``repro_torch.mapping.sam`` writer:
    an @HD/@SQ/@PG header (one @SQ per reference read) and one record per
    pair.

    The mate (*text*) maps onto reference read i at POS 1, MAPQ 255
    (unavailable: there is no candidate ranking here).  Unresolved pairs
    (score < 0) are written as unmapped records (FLAG 4, no position, no
    alignment score).
    """
    from repro_torch.mapping.extend import Mapping
    from repro_torch.mapping.sam import (header_lines, mapping_record,
                                         unmapped_record)
    names = [f"ref{i}" for i in range(len(scores))]
    for line in header_lines(names, [int(n) for n in plen],
                             program="repro_torch.launch.align",
                             cl=cl):
        out.write(line + "\n")
    for i, (s, ops) in enumerate(zip(scores, cigars)):
        text = T[i, : int(tlen[i])]
        if int(s) < 0:
            line = unmapped_record(f"read{i}", text)
        else:
            m = Mapping(read_id=i, ref_id=i, pos=0, strand=0, mapq=255,
                        score=int(s), ops=ops)
            line = mapping_record(m, text, f"read{i}", f"ref{i}")
        out.write(line + "\n")


def main(argv=None, summary: Optional[dict] = None) -> int:
    """Run the launcher; -> exit code.  ``summary`` (optional dict) is
    filled with the scores and, per mode, the phase times and rates."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=4096)
    ap.add_argument("--read-len", type=int, default=wfa_paper.read_len)
    ap.add_argument("--edit-frac", type=float, default=wfa_paper.edit_frac)
    ap.add_argument("--reads", default=None, metavar="PATH",
                    help="FASTA/FASTQ(.gz) of reads (the text side); "
                         "with --refs, replaces the synthetic generator")
    ap.add_argument("--refs", default=None, metavar="PATH",
                    help="FASTA/FASTQ(.gz) of references (the pattern "
                         "side), paired record-by-record with --reads")
    ap.add_argument("--penalties", default=None, metavar="SPEC",
                    help="penalty model: 'edit', 'linear:x,e', "
                         "'affine:x,o,e' or the bare gap-affine triple "
                         "'x,o,e' (default: the paper's affine "
                         f"{wfa_paper.pen.x},{wfa_paper.pen.o},"
                         f"{wfa_paper.pen.e})")
    ap.add_argument("--heuristic", default="none", metavar="SPEC",
                    help="wavefront heuristic: 'none' (exact, default), "
                         "'adaptive[:min_wf_len,max_distance_diff]' or "
                         "'zdrop[:z]'; results are approximate")
    ap.add_argument("--backend", choices=available_backends(),
                    default="ring")
    ap.add_argument("--device", default="cuda",
                    help="torch device the waves run on (default cuda)")
    ap.add_argument("--mode", choices=("stream", "sync", "both"),
                    default="stream",
                    help="pipelined session (default), blocking align(), "
                         "or both back-to-back")
    ap.add_argument("--output", choices=("score", "cigar", "sam"),
                    default="score",
                    help="scores only (default), full CIGAR alignments, "
                         "or SAM records")
    ap.add_argument("--sam-out", default="-", metavar="PATH",
                    help="where --output sam writes records (default "
                         "stdout)")
    ap.add_argument("--trace", choices=("packed", "bidir"),
                    default="packed",
                    help="traceback variant for --output cigar: 'packed' "
                         "(2-bit backtrace, O(s^2) trace memory) or 'bidir' "
                         "(BiWFA meet-in-the-middle recursion, O(s) trace "
                         "memory: use for long reads)")
    ap.add_argument("--submit-pairs", type=int, default=None,
                    help="pairs per session submit (default: "
                         "--chunk-pairs)")
    ap.add_argument("--inflight", type=int, default=4,
                    help="max in-flight waves (session backpressure bound)")
    ap.add_argument("--chunk-pairs", type=int, default=1024,
                    help="pairs per device wave (same for sync and stream)")
    ap.add_argument("--no-bucket", action="store_true",
                    help="disable length-bucketed batching")
    ap.add_argument("--no-adaptive", action="store_true",
                    help="disable the exact-bound overflow recovery pass")
    ap.add_argument("--verify", type=int, default=0,
                    help="cross-check N scores (and CIGAR re-scores) "
                         "against the Gotoh oracle")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="capture the measured runs as Chrome trace-event "
                         "JSON (open in ui.perfetto.dev)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="wrap the measured runs in torch.profiler; writes "
                         "DIR/trace.json")
    args = ap.parse_args(argv)
    summary = {} if summary is None else summary

    pen = (scoring.parse_penalties(args.penalties)
           if args.penalties else scoring.as_model(wfa_paper.pen))
    heur = scoring.parse_heuristic(args.heuristic)
    out_mode = "score" if args.output == "score" else "cigar"
    # SAM on stdout must stay a valid SAM stream: the progress report goes
    # to stderr then
    sam_to_stdout = args.output == "sam" and args.sam_out == "-"
    log_file = sys.stderr if sam_to_stdout else sys.stdout

    def log(*a, **kw):
        print(*a, file=log_file, flush=True, **kw)

    if (args.reads is None) != (args.refs is None):
        ap.error("--reads and --refs must be given together")
    t0 = time.perf_counter()
    if args.reads is not None:
        P, plen, T, tlen = load_pair_files(args.reads, args.refs,
                                           limit=args.pairs)
        args.pairs = int(P.shape[0])
        log(f"[align] loaded {args.pairs} read pairs from {args.reads} / "
            f"{args.refs} in {time.perf_counter() - t0:.2f}s")
    else:
        spec = ReadPairSpec(n_pairs=args.pairs, read_len=args.read_len,
                            edit_frac=args.edit_frac, seed=args.seed)
        P, plen, T, tlen = generate_pairs(spec)
        log(f"[align] generated {args.pairs} pairs of ~{args.read_len}bp "
            f"(E={args.edit_frac:.0%}) in {time.perf_counter() - t0:.2f}s")
    log(f"[align] scoring: {pen} heuristic={heur}"
        + (" (approximate scores)" if not heur.exact else ""))

    mesh = None
    if get_backend(args.backend).needs_mesh:
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh(device=args.device)
    engine = AlignmentEngine(pen, backend=args.backend,
                             edit_frac=args.edit_frac, heuristic=heur,
                             chunk_pairs=args.chunk_pairs,
                             bucket_by_length=not args.no_bucket,
                             adaptive=not args.no_adaptive,
                             trace_variant=args.trace, mesh=mesh,
                             device=args.device)
    submit_pairs = args.submit_pairs or args.chunk_pairs
    # warmup with the identical batch so the measured run is steady-state
    # (every specialisation and the kernel's library loaded); a submit-sized
    # chunk and the residual chunk warm the streamed shapes too
    engine.align_packed(P, plen, T, tlen, output=out_mode)
    engine.align_packed(P[:submit_pairs], plen[:submit_pairs],
                        T[:submit_pairs], tlen[:submit_pairs],
                        output=out_mode)
    rem = args.pairs % submit_pairs
    if rem:
        engine.align_packed(P[-rem:], plen[-rem:], T[-rem:], tlen[-rem:],
                            output=out_mode)

    runs = []
    with obs.capture_trace(args.trace_out), \
            obs.profile.profile(args.profile):
        if args.mode in ("sync", "both"):
            runs.append(("sync",
                         _run_sync(engine, P, plen, T, tlen, out_mode)))
        if args.mode in ("stream", "both"):
            with obs.trace.span("align.stream", cat="align"):
                runs.append(("stream",
                             run_streamed(engine, P, plen, T, tlen,
                                          submit_pairs=submit_pairs,
                                          max_inflight_waves=args.inflight,
                                          output=out_mode)))
    if args.trace_out:
        log(f"[align] trace -> {args.trace_out}")

    scores = cigars = None
    for mode, (sc, cg, st, wall) in runs:
        if scores is None:
            scores, cigars = sc, cg
        elif not np.array_equal(scores, sc):
            log("[align] ERROR: sync and stream scores differ")
            return 1
        pim = st.pim
        extra = ""
        if mode == "stream":
            extra = (f" submits={st.n_submits} waves={st.n_waves} "
                     f"inflight<={st.max_inflight} (peak {st.peak_inflight})")
            summary["stream_waves"] = st.n_waves
        trace = f" trace={args.trace}" if out_mode == "cigar" else ""
        log(f"[align] {mode}: backend={args.backend} output={out_mode}"
            f"{trace} device={engine.device} workers={pim.n_workers} "
            f"buckets={st.n_buckets} "
            f"cache={st.cache_hits}h/{st.cache_misses}m "
            f"first_uses={st.n_traces}{extra}")
        log(f"[align] {mode}: scatter {pim.t_scatter:.4f}s  "
            f"kernel {pim.t_kernel:.4f}s  gather {pim.t_gather:.4f}s  "
            f"wall {wall:.4f}s")
        log(f"[align] {mode}: throughput Total  = "
            f"{args.pairs / wall:,.0f} pairs/s")
        log(f"[align] {mode}: throughput Kernel = "
            f"{pim.throughput_kernel():,.0f} pairs/s")
        log(f"[align] {mode}: transfers: {pim.bytes_in / 1e6:.1f} MB in, "
            f"{pim.bytes_out / 1e6:.3f} MB out")
        found = sc >= 0
        log(f"[align] {mode}: scores: mean={sc[found].mean():.2f} "
            f"max={sc[found].max()} overflow={st.n_overflow} "
            f"recovered={st.n_recovered} unresolved={int((~found).sum())}")
        summary[mode] = {
            "wall_s": wall, "t_scatter": pim.t_scatter,
            "t_kernel": pim.t_kernel, "t_gather": pim.t_gather,
            "total_pairs_per_s": args.pairs / wall,
            "kernel_pairs_per_s": pim.throughput_kernel(),
            "n_overflow": st.n_overflow, "n_recovered": st.n_recovered}
        if cg is not None:
            ident = np.asarray([cigar_mod.cigar_identity(c)
                                for c, f in zip(cg, found) if f])
            cols = sum(len(c) for c in cg)
            log(f"[align] {mode}: cigars: {cols} alignment columns, "
                f"identity mean={ident.mean():.4f} min={ident.min():.4f} "
                f"(gather incl. traceback: {pim.t_gather:.3f}s)")
            log(f"[align] {mode}: peak_trace_bytes={st.peak_trace_bytes} "
                f"n_bidir_fallback={st.n_bidir_fallback} "
                f"n_meet_unmet={st.n_meet_unmet}")
            summary[mode].update(peak_trace_bytes=st.peak_trace_bytes,
                                 n_bidir_fallback=st.n_bidir_fallback,
                                 n_meet_unmet=st.n_meet_unmet)
    summary["scores"] = scores
    summary["cigars"] = cigars
    if args.mode == "both":
        t_sync = runs[0][1][3]
        t_stream = runs[1][1][3]
        log(f"[align] stream vs sync wall: {t_sync:.3f}s -> {t_stream:.3f}s "
            f"({t_sync / t_stream:.2f}x)")

    if args.output == "sam":
        cl = "repro_torch.launch.align " + " ".join(argv or sys.argv[1:])
        if args.sam_out == "-":
            write_sam(sys.stdout, scores, cigars, plen, T, tlen, cl=cl)
        else:
            with open(args.sam_out, "w") as f:
                write_sam(f, scores, cigars, plen, T, tlen, cl=cl)
            log(f"[align] wrote {args.pairs} SAM records to "
                f"{args.sam_out}")

    if args.verify:
        n = min(args.verify, args.pairs)
        pen_triple = pen.as_penalties()
        for i in range(n):
            pa, ta = P[i, : plen[i]], T[i, : tlen[i]]
            g = gotoh_score_vec(pa, ta, pen_triple)
            # heuristic scores are an upper bound, not the exact optimum
            bad = (scores[i] != g if heur.exact else scores[i] < g)
            if scores[i] >= 0 and bad:
                log(f"[align] MISMATCH pair {i}: wfa={scores[i]} gotoh={g}")
                return 1
            if cigars is not None and scores[i] >= 0:
                cost, ci, cj, ok = score_cigar(cigars[i], pa, ta, pen_triple)
                if not ok or cost != scores[i]:
                    log(f"[align] CIGAR MISMATCH pair {i}: "
                        f"re-score={cost} wfa={scores[i]} ok={ok}")
                    return 1
        what = "scores + CIGARs" if cigars is not None else "scores"
        against = ("Gotoh oracle" if heur.exact
                   else "Gotoh oracle (upper-bound check: heuristic)")
        log(f"[align] verified {n} {what} against {against}")
        summary["verified"] = n
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Read-mapping launcher — FASTQ reads onto FASTA references, end to end,
on the card.

Build (or load) a minimizer index over the references, generate candidate
loci per read by colinear chaining, verify candidates as batched WFA
extensions through ``AlignmentEngine.stream()`` (CIGAR mode: on the
``kernel`` backend every extension wave runs the CUDA trace kernel), and
emit SAM.

    python -m repro_torch.launch.map_reads --backend kernel \
        --refs ref.fa --reads reads.fq --sam-out out.sam     # on the card
    python -m repro_torch.launch.map_reads --device cpu \
        --refs ref.fa --reads reads.fq --sam-out out.sam

``--index``/``--save-index`` reuse a pickled index across runs (built
once, shared by every query; an index pickled by the JAX package does not
load here).  ``--penalties``/``--heuristic`` are the per-submit scoring
seam; ``--backend`` any registered engine backend; ``--device`` where the
waves run (default ``cuda``).  Progress goes to stderr when SAM goes to
stdout, so ``... --sam-out - > out.sam`` stays a valid SAM stream.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from repro_torch import obs
from repro_torch.core import scoring
from repro_torch.core.backends import available_backends
from repro_torch.core.engine import AlignmentEngine
from repro_torch.data.io import read_seqs
from repro_torch.mapping.extend import ReadMapper, suggested_edit_frac
from repro_torch.mapping.index import MinimizerIndex
from repro_torch.mapping.sam import write_sam


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", required=True, metavar="PATH",
                    help="FASTA/FASTQ(.gz) reads to map")
    ap.add_argument("--refs", default=None, metavar="PATH",
                    help="FASTA/FASTQ(.gz) references to index (required "
                         "unless --index loads a prebuilt one)")
    ap.add_argument("--index", default=None, metavar="PATH",
                    help="load a pickled MinimizerIndex instead of "
                         "building from --refs")
    ap.add_argument("--save-index", default=None, metavar="PATH",
                    help="pickle the built index for reuse")
    ap.add_argument("--k", type=int, default=None,
                    help="minimizer k-mer size (default 15; build-time "
                         "only — ignored with --index)")
    ap.add_argument("--w", type=int, default=None,
                    help="minimizer window, keep 1 of w consecutive "
                         "k-mers (default 10; build-time only)")
    ap.add_argument("--occ-cap", type=int, default=None,
                    help="drop seeds with more reference occurrences "
                         "(default 64; build-time only)")
    ap.add_argument("--top-n", type=int, default=2,
                    help="candidate loci verified per read "
                         "(primary + secondaries)")
    ap.add_argument("--edit-frac", type=float, default=0.02,
                    help="expected read divergence E (window + bound sizing)")
    ap.add_argument("--penalties", default=None, metavar="SPEC",
                    help="penalty model: 'edit', 'linear:x,e', "
                         "'affine:x,o,e' or the bare triple 'x,o,e'")
    ap.add_argument("--heuristic", default="none", metavar="SPEC",
                    help="wavefront heuristic: 'none' (exact, default), "
                         "'adaptive[:min_wf_len,max_distance_diff]' or "
                         "'zdrop[:z]'")
    ap.add_argument("--backend", choices=available_backends(),
                    default="ring")
    ap.add_argument("--device", default="cuda",
                    help="torch device the waves run on (default cuda)")
    ap.add_argument("--batch-reads", type=int, default=256,
                    help="reads per session submit (ticket granularity)")
    ap.add_argument("--inflight", type=int, default=2,
                    help="max in-flight waves (session backpressure)")
    ap.add_argument("--limit", type=int, default=0,
                    help="map only the first N reads (0 = all)")
    ap.add_argument("--sam-out", default="-", metavar="PATH",
                    help="SAM output (default stdout)")
    ap.add_argument("--cigar-mode", choices=("classic", "extended"),
                    default="classic",
                    help="CIGAR spelling: pre-1.4 M (default) or 1.4 =/X")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="capture the mapping pass as Chrome trace-event "
                         "JSON (open in ui.perfetto.dev)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="wrap the mapping pass in torch.profiler; "
                         "writes DIR/trace.json")
    args = ap.parse_args(argv)

    sam_to_stdout = args.sam_out == "-"
    log_file = sys.stderr if sam_to_stdout else sys.stdout

    def log(*a, **kw):
        print(*a, file=log_file, flush=True, **kw)

    if args.index is None and args.refs is None:
        ap.error("need --refs (build an index) or --index (load one)")

    t0 = time.perf_counter()
    if args.index is not None:
        if any(v is not None for v in (args.k, args.w, args.occ_cap)):
            ap.error("--k/--w/--occ-cap are index build parameters; they "
                     "cannot be applied to a prebuilt --index (rebuild "
                     "from --refs to change them)")
        index = MinimizerIndex.load(args.index)
        log(f"[map] loaded index {args.index}: {index.n_refs} refs, "
            f"{index.n_occurrences} seed occurrences, "
            f"{index.nbytes() / 1e6:.1f} MB "
            f"in {time.perf_counter() - t0:.2f}s")
    else:
        names, seqs = read_seqs(args.refs)
        t1 = time.perf_counter()
        k = 15 if args.k is None else args.k
        w = 10 if args.w is None else args.w
        occ_cap = 64 if args.occ_cap is None else args.occ_cap
        index = MinimizerIndex.build(seqs, names, k=k, w=w, occ_cap=occ_cap)
        dt = time.perf_counter() - t1
        total = int(index.lengths.sum())
        log(f"[map] indexed {index.n_refs} refs ({total} bp) in {dt:.2f}s "
            f"({total / max(dt, 1e-9) / 1e6:.1f} Mbp/s): "
            f"{index.n_occurrences} seed occurrences "
            f"({index.n_seeds_capped} capped at occ>{occ_cap}), "
            f"{index.nbytes() / 1e6:.1f} MB")
    if args.save_index:
        index.save(args.save_index)
        log(f"[map] saved index to {args.save_index}")

    read_names, reads = read_seqs(args.reads)
    if args.limit:
        read_names, reads = (read_names[:args.limit], reads[:args.limit])
    log(f"[map] loaded {len(reads)} reads from {args.reads}")

    pen = (scoring.parse_penalties(args.penalties)
           if args.penalties else scoring.as_model(None))
    heur = scoring.parse_heuristic(args.heuristic)
    read_len = int(np.median([len(r) for r in reads])) if reads else 100
    engine = AlignmentEngine(
        pen, backend=args.backend, heuristic=heur, device=args.device,
        edit_frac=suggested_edit_frac(pen, args.edit_frac, read_len))
    mapper = ReadMapper(index, engine, top_n=args.top_n,
                        edit_frac=args.edit_frac, read_len=read_len,
                        batch_reads=args.batch_reads, penalties=pen,
                        heuristic=heur)

    cl = "repro_torch.launch.map_reads " + " ".join(argv or sys.argv[1:])
    t2 = time.perf_counter()
    with obs.capture_trace(args.trace_out), \
            obs.profile.profile(args.profile):
        stream = mapper.map_stream(reads, max_inflight_waves=args.inflight)
        if sam_to_stdout:
            n_rec = write_sam(sys.stdout, stream, reads, read_names,
                              index.names, index.lengths,
                              mode=args.cigar_mode, cl=cl)
        else:
            with open(args.sam_out, "w") as f:
                n_rec = write_sam(f, stream, reads, read_names, index.names,
                                  index.lengths, mode=args.cigar_mode,
                                  cl=cl)
    wall = time.perf_counter() - t2
    if args.trace_out:
        log(f"[map] trace -> {args.trace_out}")

    st = mapper.stats
    log(f"[map] mapped {st.n_mapped}/{st.n_reads} reads "
        f"({st.candidates_per_read:.2f} candidates/read, "
        f"{st.n_unresolved} unresolved extensions, "
        f"{st.n_tickets} tickets) -> {n_rec} SAM records"
        + ("" if sam_to_stdout else f" in {args.sam_out}"))
    log(f"[map] throughput: {st.n_reads / max(wall, 1e-9):,.0f} reads/s "
        f"({st.n_extensions / max(wall, 1e-9):,.0f} extensions/s), "
        f"wall {wall:.3f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

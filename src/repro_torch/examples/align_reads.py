"""The paper's scenario end to end: generate read pairs at an edit
threshold, stream them through the engine's AlignmentSession (async
submits, pipelined waves, out-of-order gather) and report Total vs Kernel
throughput (Fig. 1's decomposition).  ``--output cigar`` streams full
alignments; ``--output sam`` writes SAM records.  This is
``repro_torch.launch.align``; every flag is its flag.

    python -m repro_torch.examples.align_reads --pairs 20000 --edit-frac 0.02
    python -m repro_torch.examples.align_reads --backend kernel --mode both
    python -m repro_torch.examples.align_reads --backend shardmap --verify 64
    python -m repro_torch.examples.align_reads --output cigar --verify 128
    python -m repro_torch.examples.align_reads --output sam --sam-out out.sam
    python -m repro_torch.examples.align_reads --penalties edit --verify 64
    python -m repro_torch.examples.align_reads --device cpu --pairs 256
"""
import sys

from repro_torch.launch.align import main

if __name__ == "__main__":
    sys.exit(main())

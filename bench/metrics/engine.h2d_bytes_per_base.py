"""``engine.h2d_bytes_per_base``: bytes the session copied to the card
(``SessionStats.bytes_in``, which counts padding columns and 4-byte
codes) over the bases handed to it (the sum of ``plen + tlen`` of every
chunk submitted in the run's session)."""


def read(run):
    if not run.bases_in:
        return None
    return run.stats.bytes_in / run.bases_in

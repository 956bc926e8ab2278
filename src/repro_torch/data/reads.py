"""Synthetic read-pair generator — the paper's workload.

The paper aligns 5M pairs of 100bp reads whose divergence is bounded by an
edit-distance threshold E (2% / 4%).  We reproduce that regime: a reference
read is sampled uniformly over {A,C,G,T}; its mate is the read mutated with
at most ``ceil(E*L)`` edits (substitutions / 1-base insertions / deletions,
mixed like real sequencing error profiles).  Deterministic per (seed, index)
so restarts and shards regenerate identical data (fault-tolerance contract).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


@dataclasses.dataclass(frozen=True)
class ReadPairSpec:
    n_pairs: int = 1000
    read_len: int = 100
    edit_frac: float = 0.02        # the paper's E
    sub_prob: float = 0.6          # edit mix: substitution vs indel
    ins_prob: float = 0.2
    seed: int = 0


def _mutate(rng: np.random.Generator, read: np.ndarray, n_edits: int,
            sub_prob: float, ins_prob: float) -> np.ndarray:
    seq = list(read)
    for _ in range(n_edits):
        r = rng.random()
        pos = int(rng.integers(0, max(1, len(seq))))
        if r < sub_prob and seq:
            old = seq[pos]
            choices = [b for b in BASES if b != old]
            seq[pos] = choices[int(rng.integers(0, 3))]
        elif r < sub_prob + ins_prob:
            seq.insert(pos, int(BASES[int(rng.integers(0, 4))]))
        elif seq:
            del seq[pos]
    return np.asarray(seq, np.uint8)


def generate_pairs(spec: ReadPairSpec) -> Tuple[np.ndarray, np.ndarray,
                                                np.ndarray, np.ndarray]:
    """-> (patterns [N, Lp], plens [N], texts [N, Lt], tlens [N]) int32.

    Mates can differ in length by up to ceil(E*L) (indels), so arrays are
    padded to the batch max; padding is never read by the aligner.
    """
    rng = np.random.default_rng(spec.seed)
    L = spec.read_len
    n_err = int(np.ceil(spec.edit_frac * L))
    pats, texts = [], []
    for i in range(spec.n_pairs):
        ref = BASES[rng.integers(0, 4, size=L)]
        n_edits = int(rng.integers(0, n_err + 1))
        mate = _mutate(rng, ref, n_edits, spec.sub_prob, spec.ins_prob)
        pats.append(ref)
        texts.append(mate)
    # an empty batch gives empty [0, 0] arrays
    Lp = max((len(p) for p in pats), default=0)
    Lt = max((len(t) for t in texts), default=0)
    P = np.zeros((spec.n_pairs, Lp), np.int32)
    T = np.zeros((spec.n_pairs, Lt), np.int32)
    plen = np.empty((spec.n_pairs,), np.int32)
    tlen = np.empty((spec.n_pairs,), np.int32)
    for i, (p, t) in enumerate(zip(pats, texts)):
        P[i, : len(p)] = p
        T[i, : len(t)] = t
        plen[i] = len(p)
        tlen[i] = len(t)
    return P, plen, T, tlen


def generate_shard(spec: ReadPairSpec, shard: int, n_shards: int):
    """Deterministic shard: pairs [shard::n_shards] regenerate identically
    regardless of worker count — the restart/straggler-skip contract."""
    sub = dataclasses.replace(
        spec,
        n_pairs=(spec.n_pairs - shard + n_shards - 1) // n_shards,
        seed=spec.seed * 1_000_003 + shard,
    )
    return generate_pairs(sub)


@dataclasses.dataclass(frozen=True)
class ArrivalSpec:
    """An open-loop serving workload: request payloads + Poisson arrivals.

    ``n_requests`` independent requests of ``pairs_per_request`` read
    pairs each, drawn from the paper's E-bounded mutation model, arriving
    as a Poisson process (i.i.d. exponential inter-arrival gaps) whose
    rate is set at replay time — the trace stores payloads and *unit-rate*
    arrival offsets so one trace serves every offered-load point.
    Deterministic per seed (the restart/shard contract of
    :func:`generate_pairs` extends to serving traces).
    """
    n_requests: int = 256
    pairs_per_request: int = 8
    read_len: int = 100
    edit_frac: float = 0.02
    sub_prob: float = 0.6
    ins_prob: float = 0.2
    seed: int = 0


def poisson_arrivals(n: int, rate: float, seed: int = 0) -> np.ndarray:
    """[n] sorted arrival offsets (seconds from trace start) of a Poisson
    process with ``rate`` requests/s — i.i.d. exponential gaps, the
    open-loop benchmark's arrival law.  Deterministic per seed."""
    if rate <= 0:
        raise ValueError("rate must be > 0")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(scale=1.0 / rate, size=int(n))
    return np.cumsum(gaps)


def generate_trace(spec: ArrivalSpec):
    """-> (payloads, unit_arrivals): per-request packed pairs + unit-rate
    Poisson offsets.

    ``payloads[i]`` is ``(P, plen, T, tlen)`` for request ``i`` (views
    into one shared batch — no per-request copies); divide
    ``unit_arrivals`` by the offered rate (requests/s) at replay time.
    """
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=spec.n_requests * spec.pairs_per_request,
        read_len=spec.read_len, edit_frac=spec.edit_frac,
        sub_prob=spec.sub_prob, ins_prob=spec.ins_prob, seed=spec.seed))
    k = spec.pairs_per_request
    payloads = [(P[i * k:(i + 1) * k], plen[i * k:(i + 1) * k],
                 T[i * k:(i + 1) * k], tlen[i * k:(i + 1) * k])
                for i in range(spec.n_requests)]
    return payloads, poisson_arrivals(spec.n_requests, 1.0,
                                      seed=spec.seed + 1)


@dataclasses.dataclass(frozen=True)
class SampledRead:
    """One ground-truth read: where it came from and how mutated it is.

    ``pos`` is the 0-based start of the sampled window on the *forward*
    reference strand; ``strand`` is 1 when the read is the reverse
    complement of that window (mutations applied after the flip);
    ``win_len`` is the window's length on the reference (== the read
    length before mutation — per-read under ``length_dist``).
    """
    read: np.ndarray            # ASCII uint8 sequence as a mapper sees it
    pos: int
    strand: int                 # 0 = forward, 1 = reverse complement
    n_edits: int
    win_len: int = -1


# named error mixes: (sub_prob, ins_prob); deletions take the remainder.
# "ont" is the nanopore-like profile — indel-dominated (~40/30/30
# sub/ins/del), vs the paper's short-read default (~60/20/20).
ERROR_PROFILES = {"ont": (0.4, 0.3)}


def sample_from_reference(ref, n_reads: int, *, read_len: int = 100,
                          edit_frac: float = 0.02, rc_frac: float = 0.5,
                          sub_prob: float = 0.6, ins_prob: float = 0.2,
                          length_dist: str | None = None,
                          length_sigma: float = 0.35,
                          error_profile: str | None = None,
                          seed: int = 0):
    """Draw reads from a reference at known positions/strands -> ground truth.

    The mapping-recall oracle: each read is a uniform window of ``ref``
    (ASCII uint8 array or str), reverse-complemented with probability
    ``rc_frac``, then mutated with at most ``ceil(edit_frac * win_len)``
    edits under the paper's mutation model (same substitution/indel mix as
    :func:`generate_pairs`).  Deterministic per seed, so recall/precision
    numbers are reproducible.  Returns a list of :class:`SampledRead`.

    Long-read extensions (the BiWFA workload):

    * ``length_dist="lognormal"`` draws each window length from an
      ONT-like lognormal with median ``read_len`` and shape
      ``length_sigma`` (clamped to ``[16, len(ref)]``) instead of the
      fixed short-read length;
    * ``error_profile="ont"`` switches the edit mix to the
      indel-dominated nanopore profile (~40/30/30 sub/ins/del),
      overriding ``sub_prob``/``ins_prob``.
    """
    from repro_torch.data.dna import as_ascii, revcomp
    ref = as_ascii(ref)
    if len(ref) < read_len:
        raise ValueError(f"reference ({len(ref)}bp) shorter than "
                         f"read_len ({read_len})")
    if length_dist not in (None, "lognormal"):
        raise ValueError(f"unknown length_dist: {length_dist!r}")
    if error_profile is not None:
        try:
            sub_prob, ins_prob = ERROR_PROFILES[error_profile]
        except KeyError:
            raise ValueError(f"unknown error_profile: {error_profile!r} "
                             f"(have {sorted(ERROR_PROFILES)})") from None
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(int(n_reads)):
        if length_dist == "lognormal":
            wlen = int(round(read_len * np.exp(
                rng.normal(0.0, length_sigma))))
            wlen = max(16, min(wlen, len(ref)))
        else:
            wlen = read_len
        pos = int(rng.integers(0, len(ref) - wlen + 1))
        strand = int(rng.random() < rc_frac)
        window = ref[pos: pos + wlen]
        if strand:
            window = revcomp(window)
        n_err = int(np.ceil(edit_frac * wlen))
        n_edits = int(rng.integers(0, n_err + 1))
        read = _mutate(rng, window, n_edits, sub_prob, ins_prob)
        out.append(SampledRead(read=read.astype(np.uint8), pos=pos,
                               strand=strand, n_edits=n_edits,
                               win_len=wlen))
    return out

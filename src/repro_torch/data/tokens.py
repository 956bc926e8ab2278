"""Deterministic synthetic LM token pipeline (the JAX package's
``data/tokens.py``, copied: numpy only, so batches are byte-identical to
the JAX package's for every ``(seed, step, shard)``).

Every batch is a pure function of (seed, step, shard) — the property the
fault-tolerance story relies on: a restarted worker, or a healthy worker
taking over a straggler's shard, regenerates byte-identical data, so
training continues without divergence and without a data-journal service.

The stream is a Zipf-ish unigram mix with short repeated motifs so the loss
actually decreases during the examples' few-hundred-step runs (pure uniform
tokens would pin the loss at log V).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenStreamSpec:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    motif_len: int = 8
    n_motifs: int = 64


def _rng_for(spec: TokenStreamSpec, step: int, shard: int):
    return np.random.default_rng(
        (spec.seed * 1_000_003 + step) * 65_537 + shard)


def _motifs(spec: TokenStreamSpec) -> np.ndarray:
    rng = np.random.default_rng(spec.seed ^ 0x5EED)
    return rng.integers(0, spec.vocab_size,
                        size=(spec.n_motifs, spec.motif_len), dtype=np.int32)


def batch_for_step(spec: TokenStreamSpec, step: int, *, shard: int = 0,
                   n_shards: int = 1) -> dict:
    """-> {"tokens": [b, S], "targets": [b, S]} for this worker's shard."""
    assert spec.global_batch % n_shards == 0, (spec.global_batch, n_shards)
    b = spec.global_batch // n_shards
    rng = _rng_for(spec, step, shard)
    motifs = _motifs(spec)
    n_blocks = spec.seq_len // spec.motif_len + 1
    ids = rng.integers(0, spec.n_motifs, size=(b, n_blocks))
    toks = motifs[ids].reshape(b, -1)[:, : spec.seq_len].astype(np.int32)
    # sprinkle noise so the task is not purely memorizable
    noise = rng.random((b, spec.seq_len)) < 0.05
    toks = np.where(noise,
                    rng.integers(0, spec.vocab_size, size=(b, spec.seq_len),
                                 dtype=np.int32),
                    toks)
    targets = np.concatenate([toks[:, 1:], np.full((b, 1), -1, np.int32)],
                             axis=1)
    return {"tokens": toks, "targets": targets}

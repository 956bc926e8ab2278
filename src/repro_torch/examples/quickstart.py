"""Quickstart: the unified AlignmentEngine API, on the card.

One object covers every alignment scenario:

* ``AlignmentEngine(backend=...)`` picks an execution strategy from the
  backend registry — ``"ref"`` (full history), ``"ring"`` (rolling
  window), ``"kernel"`` (the hand-written CUDA kernel; its plain PyTorch
  version on the CPU), ``"shardmap"`` (one independent shard per device of
  a mesh) — and plug-ins can ``register_backend`` their own.
* Every call picks an output mode: ``output="score"`` (default) or
  ``output="cigar"`` — full alignments on any built-in backend, via the
  packed 2-bit backtrace (``ring``/``kernel``/``shardmap``) or the full
  history (``ref``).
* Mixed-length batches are split into power-of-two length buckets, so short
  pairs never pay the longest pair's padded band; specialisations are
  cached per bucket shape.
* With ``edit_frac`` (the paper's E), bounds are sized optimistically and
  the rare over-budget pair is re-run with exact worst-case bounds.
* ``engine.stream()`` opens an ``AlignmentSession`` — async ``submit()``,
  pipelined waves, out-of-order ``as_completed()``.

    python -m repro_torch.examples.quickstart               # on the card
    python -m repro_torch.examples.quickstart --device cpu

(The old ``WFAligner`` / ``PIMBatchAligner`` names still work as deprecated
wrappers over the engine.)
"""
import argparse

import numpy as np

from repro_torch.core import (DEFAULT, AlignmentEngine, Penalties,
                              available_backends)
from repro_torch.core.gotoh import gotoh_score
from repro_torch.launch.mesh import make_host_mesh

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="where the waves run (default: cuda)")
args = ap.parse_args()
dev = args.device

print("registered backends:", available_backends())
assert "shardmap" in available_backends()

# -- 1. score + CIGAR for a handful of pairs ------------------------------
# output="cigar" works on every built-in backend: "ring"/"kernel" record a
# packed 2-bit backtrace (~16x smaller than "ref"'s full history)
engine = AlignmentEngine(DEFAULT, backend="kernel", device=dev)
patterns = ["ACGTTAGCCA", "GATTACA", "TTTTTTTT"]
texts = ["ACGTCAGCCA", "GATTTACA", "TTTT"]
res = engine.align(patterns, texts, output="cigar")

print("gap-affine penalties:", DEFAULT, "on", engine.device)
for p, t, s, c, cc in zip(patterns, texts, res.scores, res.cigar_strings(),
                          res.cigar_strings("classic")):
    print(f"  {p:12s} vs {t:12s} -> cost {s:3d}  cigar {c}  ({cc})")

# -- 2. exactness: WFA == dense Gotoh DP (the paper's correctness contract)
for p, t, s in zip(patterns, texts, res.scores):
    g = gotoh_score(np.frombuffer(p.encode(), np.uint8),
                    np.frombuffer(t.encode(), np.uint8), DEFAULT)
    assert s == g, (p, t, s, g)
print("all scores match the dense DP oracle")

# -- 3. throughput mode: mixed-length batch, bucketed + cached -------------
rng = np.random.default_rng(0)
bases = np.frombuffer(b"ACGT", np.uint8)
refs = ["".join(map(chr, bases[rng.integers(0, 4, int(L))]))
        for L in rng.integers(64, 512, size=1000)]
mates = [r[:10] + ("A" if r[10] != "A" else "C") + r[11:] for r in refs]

fast = AlignmentEngine(DEFAULT, backend="kernel", edit_frac=0.04,
                       device=dev)
res = fast.align(refs, mates)
print(f"batch of {len(refs)}: mean cost {res.scores.mean():.2f} across "
      f"{res.stats.n_buckets} length buckets "
      f"({res.stats.n_overflow} overflow -> {res.stats.n_recovered} "
      f"recovered)")
for i in range(0, len(refs), 97):
    g = gotoh_score(np.frombuffer(refs[i].encode(), np.uint8),
                    np.frombuffer(mates[i].encode(), np.uint8), DEFAULT)
    assert res.scores[i] == g, (i, res.scores[i], g)

res2 = fast.align(refs, mates)   # serving-time call: all cached
print(f"second call: {res2.stats.cache_hits} cache hits, "
      f"{res2.stats.n_traces} first uses")

# -- 4. streaming: async submit, pipelined waves, out-of-order gather ------
with fast.stream(max_inflight_waves=4) as sess:
    tickets = [sess.submit(refs[lo:lo + 250], mates[lo:lo + 250])
               for lo in range(0, len(refs), 250)]
    done_order = [t.index for t in sess.as_completed()]
print(f"streamed {sess.stats.n_submits} submits as {sess.stats.n_waves} "
      f"waves (peak {sess.stats.peak_inflight} in flight, "
      f"{sess.stats.n_traces} first uses); completion order {done_order}")
streamed = np.concatenate([t.result().scores for t in tickets])
assert streamed.tolist() == res.scores.tolist()
print("streamed scores identical to the blocking path")

# -- 5. shardmap: one independent shard per device of the host's mesh ------
mesh = make_host_mesh(device=dev)
shard = AlignmentEngine(DEFAULT, backend="shardmap", edit_frac=0.04,
                        mesh=mesh)
got = shard.align(refs, mates)
assert got.scores.tolist() == res.scores.tolist()
print(f"shardmap on {mesh.size} shard(s) of {list(mesh.shape.items())}: "
      f"scores identical to the kernel backend")

# -- 6. edit distance is just another penalty setting ----------------------
ed = AlignmentEngine(Penalties(x=1, o=0, e=1), backend="ring", device=dev)
print("edit('kitten','sitting') =",
      ed.align(["kitten"], ["sitting"]).scores[0])

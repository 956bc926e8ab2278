"""The port's read mapper (``repro_torch.mapping``) against the JAX one:
index arrays and minimizers, chains, every ``Mapping`` field and the SAM
text, on the fixtures of ``tests/test_mapping.py`` (a 20 kb seeded
reference, seeded reads on both strands), on the ``ring``, ``kernel``
(its plain version on CPU tensors) and ``ref`` backends; then the
``map_reads`` launcher and ``align --output sam`` end to end."""
import dataclasses
import io

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core.scoring import Edit as JEdit  # noqa: E402
from repro.data.reads import sample_from_reference  # noqa: E402
from repro.launch import align as j_align  # noqa: E402
from repro.launch import map_reads as j_map_reads  # noqa: E402
from repro.mapping import chain as j_chain  # noqa: E402
from repro.mapping.extend import ReadMapper as JMapper  # noqa: E402
from repro.mapping.index import MinimizerIndex as JIndex  # noqa: E402
from repro.mapping.index import extract_minimizers as j_minimizers  # noqa: E402
from repro.mapping.sam import write_sam as j_write_sam  # noqa: E402
from repro_torch.core.gotoh import score_cigar  # noqa: E402
from repro_torch.core.scoring import Edit  # noqa: E402
from repro_torch.data.dna import random_reference, revcomp  # noqa: E402
from repro_torch.launch import align as t_align  # noqa: E402
from repro_torch.launch import map_reads as t_map_reads  # noqa: E402
from repro_torch.mapping import chain as t_chain  # noqa: E402
from repro_torch.mapping import (MinimizerIndex, ReadMapper,  # noqa: E402
                                 write_sam)
from repro_torch.mapping.index import extract_minimizers  # noqa: E402

K, W = 15, 10
BACKENDS = ["ring", "kernel", "ref"]
INDEX_ARRAYS = ("lengths", "table_key", "table_start", "table_count",
                "occ_ref", "occ_pos", "occ_strand")


@pytest.fixture(scope="module")
def ref():
    return random_reference(20000, seed=1)


@pytest.fixture(scope="module")
def indexes(ref):
    return (JIndex.build([ref], ["chr1"], k=K, w=W, occ_cap=64),
            MinimizerIndex.build([ref], ["chr1"], k=K, w=W, occ_cap=64))


@pytest.fixture(scope="module")
def reads(ref):
    return sample_from_reference(ref, 60, read_len=100, edit_frac=0.02,
                                 seed=3)


def _same_index(a, b):
    for f in INDEX_ARRAYS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert (a.k, a.w, a.occ_cap, a.names, a.n_seeds_total,
            a.n_seeds_capped) == (b.k, b.w, b.occ_cap, b.names,
                                  b.n_seeds_total, b.n_seeds_capped)
    for s, t in zip(a.seqs, b.seqs, strict=True):
        np.testing.assert_array_equal(s, t)


def test_index_arrays_equal(indexes):
    _same_index(*indexes)


def test_index_with_repeats_and_short_sequences():
    motif = random_reference(200, seed=7)
    seqs = [np.concatenate([motif] * 12), "ACGT", "",
            random_reference(3000, seed=8)]
    a = JIndex.build(seqs, occ_cap=4)
    b = MinimizerIndex.build(seqs, occ_cap=4)
    _same_index(a, b)
    assert b.n_seeds_capped > 0


@pytest.mark.parametrize("k,w", [(15, 10), (11, 5), (21, 1)])
def test_minimizers_equal(ref, k, w):
    seq = ref[:3000].copy()
    seq[500:520] = ord("N")
    for s in (seq, revcomp(seq), "ACGTACGTAC", ""):
        for x, y in zip(j_minimizers(s, k, w), extract_minimizers(s, k, w),
                        strict=True):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_index_save_load_roundtrip(indexes, tmp_path):
    path = str(tmp_path / "idx.pkl")
    indexes[1].save(path)
    loaded = MinimizerIndex.load(path)
    _same_index(indexes[0], loaded)
    with pytest.raises(TypeError, match="not a pickled MinimizerIndex"):
        indexes[0].save(path)   # the JAX class: refused by the port's load
        MinimizerIndex.load(path)


def test_candidates_equal(ref, indexes, reads):
    noisy = sample_from_reference(ref, 40, read_len=100, edit_frac=0.06,
                                  seed=12)
    for r in [*reads, *noisy]:
        for top_n in (1, 2, 5):
            a = j_chain.candidates(indexes[0], r.read, top_n=top_n)
            b = t_chain.candidates(indexes[1], r.read, top_n=top_n)
            assert [dataclasses.astuple(c) for c in a] == \
                [dataclasses.astuple(c) for c in b]
        anchors = [j_chain.read_anchors(indexes[0], r.read),
                   t_chain.read_anchors(indexes[1], r.read)]
        for x, y in zip(*anchors, strict=True):
            np.testing.assert_array_equal(x, y)


def _records(maps):
    """Every field of every Mapping, the op arrays as lists."""
    out = []
    for ms in maps:
        out.append([tuple(None if v is None else
                          (v.tolist() if isinstance(v, np.ndarray) else v)
                          for v in dataclasses.astuple(m)) for m in ms])
    return out


def _sam(write, maps, reads, names, index):
    buf = io.StringIO()
    write(buf, maps, reads, names, index.names, index.lengths)
    return buf.getvalue()


def _stats(st):
    e = st.engine
    return (st.n_reads, st.n_mapped, st.n_candidates, st.n_unresolved,
            st.n_tickets, [(b.lmax, b.s_max, b.k_max, b.n_pairs, b.recovery)
                           for b in e.buckets],
            e.n_overflow, e.n_recovered, e.rows_real, e.rows_padded)


def _mappers(indexes, backend, **kw):
    return (JMapper(indexes[0], backend=backend, **kw),
            ReadMapper(indexes[1], backend=backend, device="cpu", **kw))


@pytest.mark.parametrize("backend", BACKENDS)
def test_mapper_records_and_sam_equal(ref, indexes, reads, backend):
    """Two small tickets (batch_reads 32) of reads on both strands, reads
    at both ends of the reference (windows cut short by its ends), an
    unmappable and an empty read: the records in read order, the SAM text
    (both CIGAR spellings) and the pass's counters are identical; every
    record re-scores to its cost against ref[pos : pos + ref_span]."""
    ends = [ref[:100], ref[-100:], revcomp(ref[:97]), revcomp(ref[-103:])]
    ends[0] = np.concatenate([ends[0][:40], ends[0][41:]])   # a deletion
    seqs = ([r.read for r in reads] + ends
            + [random_reference(100, seed=99), "ACG"])
    names = [f"r{i}" for i in range(len(seqs))]
    jm, tm = _mappers(indexes, backend, top_n=2, edit_frac=0.02,
                      read_len=100, batch_reads=32)
    want, got = jm.map(seqs), tm.map(seqs)
    assert _records(want) == _records(got)
    assert _stats(jm.stats) == _stats(tm.stats)
    assert _sam(j_write_sam, want, seqs, names, indexes[0]) == \
        _sam(write_sam, got, seqs, names, indexes[1])
    buf = [io.StringIO(), io.StringIO()]
    j_write_sam(buf[0], want, seqs, names, ["chr1"], [len(ref)],
                mode="extended")
    write_sam(buf[1], got, seqs, names, ["chr1"], [len(ref)],
              mode="extended")
    assert buf[0].getvalue() == buf[1].getvalue()
    strands = set()
    pen = tm.pen.as_penalties()
    for r, maps in zip(reads, got):
        for m in maps:
            assert m.mapped
            strands.add(m.strand)
            txt = r.read if m.strand == 0 else revcomp(r.read)
            cost, ci, cj, ok = score_cigar(
                m.ops, ref[m.pos: m.pos + m.ref_span()], txt, pen)
            assert ok and cost == m.score and cj == len(txt)
    assert strands == {0, 1}
    assert not got[-1][0].mapped and not got[-2][0].mapped
    assert [got[i][0].pos for i in range(-6, -2)] == [0, 19900, 0, 19897]


def test_out_of_order_retirement_equal(ref, indexes):
    """batch_reads=1: read 0 overflows into the recovery queue, so read 1
    retires first, in both packages; the SAM text in read order and in
    retirement order is identical."""
    noisy = ref[6000:6100].copy()
    noisy[35::3] = revcomp(noisy[35::3])[::-1]
    clean = ref[9000:9100]
    seqs, names = [noisy, clean], ["noisy", "clean"]
    jm, tm = _mappers(indexes, "kernel", top_n=1, edit_frac=0.02,
                      read_len=100, batch_reads=1)
    j_stream, t_stream = list(jm.map_stream(seqs)), list(tm.map_stream(seqs))
    assert [m[0].read_id for m in t_stream] == [1, 0]
    assert _records(j_stream) == _records(t_stream)
    assert _sam(j_write_sam, j_stream, seqs, names, indexes[0]) == \
        _sam(write_sam, t_stream, seqs, names, indexes[1])
    got = tm.map(seqs)
    assert _sam(j_write_sam, jm.map(seqs), seqs, names, indexes[0]) == \
        _sam(write_sam, got, seqs, names, indexes[1])
    assert (got[1][0].pos, got[1][0].score) == (9000, 0)
    assert tm.stats.engine.n_overflow > 0


def test_edit_seam_and_duplicate_locus_equal(ref, indexes, reads):
    """The Edit() per-submit seam, and a reverse-strand read on a
    duplicated locus (MAPQ 0, a secondary record)."""
    seqs = [r.read for r in reads[:20]]
    jm = JMapper(indexes[0], top_n=1, penalties=JEdit())
    tm = ReadMapper(indexes[1], top_n=1, penalties=Edit(), device="cpu")
    assert _records(jm.map(seqs)) == _records(tm.map(seqs))
    dup = np.concatenate([ref[:8000], ref[2000:2400]])
    idx = (JIndex.build([dup], ["chr"], k=K, w=W),
           MinimizerIndex.build([dup], ["chr"], k=K, w=W))
    jm, tm = _mappers(idx, "ring", top_n=2)
    read = revcomp(dup[2100:2200])
    want, got = jm.map([read]), tm.map([read])
    assert _records(want) == _records(got)
    assert got[0][0].mapq == 0 and got[0][1].secondary
    assert _sam(j_write_sam, want, [read], ["q"], idx[0]) == \
        _sam(write_sam, got, [read], ["q"], idx[1])


def test_mapper_default_engine_runs_on_the_card():
    """ReadMapper(engine=None) builds its engine on ``device``: None means
    the card, as for AlignmentEngine."""
    import torch
    idx = MinimizerIndex.build(["ACGTACGTACGTACGTAC"])
    assert ReadMapper(idx, device="cpu").engine.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            ReadMapper(idx)


def _write_fasta(path, names, seqs):
    with open(path, "w") as f:
        for n, s in zip(names, seqs):
            f.write(f">{n}\n{bytes(np.asarray(s, np.uint8)).decode()}\n")


def _body(path):
    return [ln for ln in open(path).read().splitlines()
            if not ln.startswith("@PG")]


def _by_read(lines):
    """SAM records grouped in read order (the launchers write them in
    retirement order)."""
    return sorted((ln for ln in lines if not ln.startswith("@")),
                  key=lambda ln: int(ln.split("\t")[0][1:]))


def test_map_reads_launcher_equal(tmp_path, ref):
    refs, reads_p = str(tmp_path / "ref.fa"), str(tmp_path / "reads.fa")
    _write_fasta(refs, ["chr1"], [ref])
    sampled = sample_from_reference(ref, 40, read_len=100, edit_frac=0.02,
                                    seed=31)
    _write_fasta(reads_p, [f"r{i}" for i in range(len(sampled))],
                 [r.read for r in sampled])
    common = ["--refs", refs, "--reads", reads_p, "--batch-reads", "16"]
    j_out, t_out = str(tmp_path / "j.sam"), str(tmp_path / "t.sam")
    idx_p = str(tmp_path / "idx.pkl")
    assert j_map_reads.main([*common, "--sam-out", j_out]) == 0
    assert t_map_reads.main([*common, "--sam-out", t_out, "--device", "cpu",
                             "--backend", "kernel",
                             "--save-index", idx_p]) == 0
    want, got = _body(j_out), _body(t_out)
    assert [ln for ln in want if ln.startswith("@")] == \
        [ln for ln in got if ln.startswith("@")]
    assert _by_read(want) == _by_read(got)
    assert len(_by_read(got)) >= len(sampled)
    # the saved index reloads and serves the same run
    again = str(tmp_path / "again.sam")
    assert t_map_reads.main(["--index", idx_p, "--reads", reads_p,
                             "--sam-out", again, "--device", "cpu"]) == 0
    assert _by_read(_body(again)) == _by_read(got)
    with pytest.raises(SystemExit):
        t_map_reads.main(["--index", idx_p, "--reads", reads_p, "--k", "21",
                          "--device", "cpu"])


@pytest.mark.parametrize("backend", ["kernel", "ref"])
def test_align_output_sam_equal(tmp_path, backend):
    """``align --output sam``: header and records equal the JAX launcher's
    (ring there: every backend gives the same alignments); --verify
    passes."""
    common = ["--pairs", "12", "--read-len", "40", "--mode", "sync",
              "--output", "sam", "--chunk-pairs", "8"]
    j_out, t_out = str(tmp_path / "j.sam"), str(tmp_path / "t.sam")
    assert j_align.main([*common, "--sam-out", j_out]) == 0
    assert t_align.main([*common, "--sam-out", t_out, "--device", "cpu",
                         "--backend", backend, "--verify", "12"]) == 0
    assert _body(j_out) == _body(t_out)
    assert sum(not ln.startswith("@") for ln in _body(t_out)) == 12

"""Read mapping, the alignment service and the ``ref`` backend on the card.

It imports no JAX, so it also runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_serve_gpu.py

Without a card it skips.  The mapper on the ``kernel`` backend (every
extension through the CUDA trace kernel) writes the same SAM text as on
``ring``; a ``ServeLoop`` with two worker threads delivers the scores of
batch mode on the same engine; the ``ref`` backend equals ``kernel``.
Everything is exact: integers and strings.
"""
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.engine import AlignmentEngine  # noqa: E402
from repro_torch.core.gotoh import gotoh_score_vec, score_cigar  # noqa: E402
from repro_torch.core.penalties import DEFAULT  # noqa: E402
from repro_torch.data.dna import random_reference, revcomp  # noqa: E402
from repro_torch.data.reads import (ArrivalSpec, ReadPairSpec,  # noqa: E402
                                    generate_pairs, generate_trace,
                                    sample_from_reference)
from repro_torch.kernels.wfa import kernel as K  # noqa: E402
from repro_torch.mapping import MinimizerIndex, ReadMapper, write_sam  # noqa: E402
from repro_torch.serve import ServeLoop, replay_trace  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _sam(mapper, reads, index):
    maps = mapper.map(reads)
    buf = io.StringIO()
    write_sam(buf, maps, reads, [f"r{i}" for i in range(len(reads))],
              index.names, index.lengths)
    return buf.getvalue(), maps


@pytest.mark.gpu
def test_mapper_kernel_equals_ring_on_the_card(cuda_device):
    ref = random_reference(200_000, seed=1)
    index = MinimizerIndex.build([ref], ["chr1"])
    sampled = sample_from_reference(ref, 1000, read_len=100, edit_frac=0.02,
                                    seed=3)
    reads = [r.read for r in sampled] + [random_reference(100, seed=99)]
    K.reset_launches()
    kern = ReadMapper(index, backend="kernel", device=cuda_device,
                      batch_reads=128)
    sam_k, maps = _sam(kern, reads, index)
    assert K.LAUNCHES["trace"] > 0
    sam_r, _ = _sam(ReadMapper(index, backend="ring", device=cuda_device,
                               batch_reads=128), reads, index)
    assert sam_k == sam_r
    hits = sum(m[0].mapped and m[0].strand == r.strand
               and abs(m[0].pos - r.pos) <= 6
               for r, m in zip(sampled, maps))
    assert hits >= 0.95 * len(sampled)
    pen = kern.pen.as_penalties()
    for r, ms in zip(sampled, maps):
        for m in ms:
            txt = r.read if m.strand == 0 else revcomp(r.read)
            cost, _, cj, ok = score_cigar(
                m.ops, ref[m.pos: m.pos + m.ref_span()], txt, pen)
            assert ok and cost == m.score and cj == len(txt)


@pytest.mark.gpu
@pytest.mark.parametrize("output", ["score", "cigar"])
def test_serve_loop_two_threads_equals_batch_mode(cuda_device, output):
    eng = AlignmentEngine(backend="kernel", edit_frac=0.02,
                          device=cuda_device)
    payloads, arrivals = generate_trace(ArrivalSpec(
        n_requests=256, pairs_per_request=8, read_len=100, seed=13))
    P, plen, T, tlen = (np.concatenate(a) for a in zip(*payloads))
    batch = eng.align_packed(P, plen, T, tlen)
    K.reset_launches()
    with ServeLoop(eng, wave_pairs=512, form_deadline=0.005,
                   n_threads=2) as server:
        report = replay_trace(server, payloads, arrivals * 1e-4,
                              output=output)
    assert K.LAUNCHES["score" if output == "score" else "trace"] > 0
    assert (report.n_ok, report.n_shed, report.n_failed) == (256, 0, 0)
    got = np.concatenate([r.scores for r in report.results])
    np.testing.assert_array_equal(got, batch.scores)
    if output == "cigar":
        cigars = [c for r in report.results for c in r.cigars]
        for i in range(0, len(cigars), 7):
            cost, _, _, ok = score_cigar(cigars[i], P[i, :plen[i]],
                                         T[i, :tlen[i]], DEFAULT)
            assert ok and cost == got[i]


@pytest.mark.gpu
def test_ref_backend_equals_kernel_on_the_card(cuda_device):
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=512, read_len=100, edit_frac=0.02, seed=4))
    ref = AlignmentEngine(backend="ref", edit_frac=0.02, device=cuda_device)
    kern = AlignmentEngine(backend="kernel", edit_frac=0.02,
                           device=cuda_device)
    a = ref.align_packed(P, plen, T, tlen, output="cigar")
    b = kern.align_packed(P, plen, T, tlen, output="cigar")
    np.testing.assert_array_equal(a.scores, b.scores)
    assert a.cigar_strings() == b.cigar_strings()
    for i in range(0, 512, 17):
        assert a.scores[i] == gotoh_score_vec(P[i, :plen[i]],
                                              T[i, :tlen[i]], DEFAULT)

"""The CUDA flash-attention kernel equals its plain version on the card.

It imports no JAX, so it also runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_flash_gpu.py

Without a card it skips.  Inputs from a seeded numpy RNG; tolerances those
of ``tests/test_kernel_flash.py``: 3e-5 in fp32 (TF32 off), 2e-2 in bf16.
bf16 outputs are also held elementwise to 2 bf16 ulps of the plain output
plus 1/16 of the mean |output| of their row (one position of one head), the
check ``chip_smoke.py`` applies: the absolute 2e-2 alone is about the size
of the outputs at long sequences.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as t_ops  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {"float32": 3e-5, "bfloat16": 2e-2}
BF16_ULPS, BF16_ROW_FLOOR = 2, 2 ** -4


def _assert_close(got, want):
    """max |got - want| within TOL; bf16 also elementwise within BF16_ULPS
    ulps of |want| + BF16_ROW_FLOOR x its row's mean |want|."""
    dtype = str(want.dtype).replace("torch.", "")
    got, want = got.float().cpu(), want.float().cpu()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL[dtype])
    if dtype == "bfloat16":
        w = want.abs()
        _, e = torch.frexp(w.clamp_min(2.0 ** -126))
        ulp = torch.ldexp(torch.ones_like(w), e - 8)
        limit = BF16_ULPS * ulp + BF16_ROW_FLOOR * w.mean(-1, keepdim=True)
        share = float(((got - want).abs() / limit).max())
        assert share <= 1, f"bf16 error {share:.3g} of the elementwise limit"


def _qkv(B, S, H, KV, dh, dtype, seed, device):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(
        (rng.standard_normal(s) * 0.5).astype(np.float32)).to(
            device=device, dtype=getattr(torch, dtype))
    return f(B, S, H, dh), f(B, S, KV, dh), f(B, S, KV, dh)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.fixture
def chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke
    return chip_smoke


@pytest.mark.gpu
def test_cuda_flash_kernel_matches_plain(cuda_device, monkeypatch):
    """MHA, GQA and MQA, causal and not, fp32 and bf16, dh 64, 128 (bf16:
    the wgmma body by default) and 80 (a width the fp32 pipes pad), ragged
    lengths; each call counts one launch under the body it ran, and where
    the wgmma body applies the mma.sync and fp32-pipe bodies run too."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    for H, KV in ((8, 8), (16, 8), (16, 1)):
        for dtype in ("float32", "bfloat16"):
            for dh in (64, 80, 128):
                for S, causal in ((250, True), (256, False)):
                    q, k, v = _qkv(2, S, H, KV, dh, dtype, S + dh,
                                   cuda_device)
                    qp, kp, vp, bq, bk = t_ops.pad_blocks(q, k, v,
                                                          causal=causal)
                    tensor_cores = dtype == "bfloat16" and dh in (64, 128)
                    bodies = ([None, "mma_sync", "fp32_pipes"]
                              if tensor_cores else [None])
                    before = t_kernel.LAUNCHES["flash_attention"]
                    paths = dict(t_kernel.PATH_LAUNCHES)
                    outs = [t_kernel.flash_attention_cuda(
                        qp, kp, vp, causal=causal, block_q=bq, block_k=bk,
                        body=body) for body in bodies]
                    torch.cuda.synchronize()
                    assert (t_kernel.LAUNCHES["flash_attention"]
                            == before + len(bodies))
                    assert {key: t_kernel.PATH_LAUNCHES[key] - n
                            for key, n in paths.items()} == {
                        "wgmma": int(tensor_cores),
                        "mma_sync": int(tensor_cores), "fp32_pipes": 1}
                    want = t_kernel.flash_attention_plain(
                        qp, kp, vp, causal=causal, block_q=bq, block_k=bk)
                    for got in outs:
                        _assert_close(got[:, :S], want[:, :S])


# (H, KV): G 1, 2, 4 (phi3.5-moe's 32/8), 8 (qwen3-32b's 64/8), 48
# (granite-34b's 48/1: 3 chunks of 16 heads x 8 positions), 48 on two KV
# heads (the chunk's head coordinate crosses a KV head), 24 and 12 (3
# chunks of 8 and of 4 heads) and 7 (qwen2-vl's 28/4: 7 chunks of one head
# x 128 positions)
WGMMA_HEADS = [(8, 8), (16, 8), (32, 8), (64, 8), (48, 1), (96, 2), (24, 1),
               (12, 1), (28, 4)]
WGMMA_HEAD_IDS = ["G1", "G2", "G4", "G8", "G48", "G48-KV2", "G24", "G12",
                  "G7"]
# (Sq, Sk, causal): a ragged q tile; few queries over many keys, both ways;
# a full square
WGMMA_SHAPES = [(250, 250, True), (128, 1024, False), (128, 1024, True),
                (256, 256, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [64, 112, 128])
@pytest.mark.parametrize("H,KV", WGMMA_HEADS, ids=WGMMA_HEAD_IDS)
@pytest.mark.parametrize("Sq,Sk,causal", WGMMA_SHAPES,
                         ids=["ragged", "keys", "keys-causal", "square"])
def test_wgmma_body_matches_plain(cuda_device, dh, H, KV, Sq, Sk, causal):
    """The wgmma body (the model path) against the plain version at dh 64,
    128 and 112 (two 64-column halves, the second's columns 112-127 zero
    filled); the call counts one launch, under "wgmma"."""
    rng = np.random.default_rng(Sq + Sk + H + dh)
    f = lambda *s: torch.from_numpy(
        (rng.standard_normal(s) * 0.5).astype(np.float32)).to(
            device=cuda_device, dtype=torch.bfloat16)
    q, k, v = f(2, Sq, H, dh), f(2, Sk, KV, dh), f(2, Sk, KV, dh)
    qp, kp, vp, bq, bk = t_ops.pad_blocks(q, k, v, causal=causal)
    paths = dict(t_kernel.PATH_LAUNCHES)
    got = t_kernel.flash_attention_cuda(qp, kp, vp, causal=causal,
                                        block_q=bq, block_k=bk, body="wgmma")
    torch.cuda.synchronize()
    assert {key: t_kernel.PATH_LAUNCHES[key] - n
            for key, n in paths.items()} == {"wgmma": 1, "mma_sync": 0,
                                             "fp32_pipes": 0}
    want = t_kernel.flash_attention_plain(qp, kp, vp, causal=causal,
                                          block_q=bq, block_k=bk)
    _assert_close(got[:, :Sq], want[:, :Sq])


@pytest.mark.gpu
@pytest.mark.parametrize("S", [250, 2048])
def test_fp32_pipes_at_dh112_matches_plain(cuda_device, S):
    """zamba2's shared attention: bf16 at dh 112, 32 query heads on 32 KV
    heads (G 1), causal.  The default body is wgmma and the fp32 pipes run
    by name; each call counts one launch under its body and equals the
    plain version."""
    q, k, v = _qkv(2, S, 32, 32, 112, "bfloat16", S + 112, cuda_device)
    qp, kp, vp, bq, bk = t_ops.pad_blocks(q, k, v, causal=True)
    want = t_kernel.flash_attention_plain(qp, kp, vp, causal=True,
                                          block_q=bq, block_k=bk)
    for body, ran in ((None, "wgmma"), ("fp32_pipes", "fp32_pipes")):
        paths = dict(t_kernel.PATH_LAUNCHES)
        got = t_kernel.flash_attention_cuda(qp, kp, vp, causal=True,
                                            block_q=bq, block_k=bk,
                                            body=body)
        torch.cuda.synchronize()
        assert {key: t_kernel.PATH_LAUNCHES[key] - n
                for key, n in paths.items()} == {
            key: int(key == ran) for key in paths}
        _assert_close(got[:, :S], want[:, :S])


@pytest.mark.gpu
def test_wgmma_dh112_store_leaves_neighbours(cuda_device):
    """The wgmma body's TMA store clips the second half's columns 112-127
    and the rows past Sq: launched straight into the first 250 positions of
    a sentinel-filled [1, 256, 32, 112] buffer, it writes those positions
    (equal to the plain version) and leaves the next 6 untouched, each of
    whose first 16 columns the last head's columns 112-127 would reach."""
    from repro_torch.kernels.flash_attention import build

    Sq, H, dh = 250, 32, 112
    q, k, v = _qkv(1, Sq, H, H, dh, "bfloat16", 112, cuda_device)
    sentinel = 3.0
    big = torch.full((1, 256, H, dh), sentinel, dtype=torch.bfloat16,
                     device=cuda_device)
    o = big[:, :Sq]
    assert o.is_contiguous()
    rc = build.load().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1, Sq, Sq, H,
        H, dh, 1, 1, 1.0 / dh ** 0.5, t_kernel.BODIES["wgmma"], -1, 1,
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    assert bool((big[:, Sq:] == sentinel).all())
    qp, kp, vp, bq, bk = t_ops.pad_blocks(q, k, v, causal=True)
    want = t_kernel.flash_attention_plain(qp, kp, vp, causal=True,
                                          block_q=bq, block_k=bk)
    _assert_close(o, want[:, :Sq])


@pytest.mark.gpu
def test_wgmma_refuses_dh80(cuda_device):
    """Asked for by name, the wgmma body refuses bf16 at dh 80 (the fp32
    pipes' padded width) and launches nothing."""
    q, k, v = _qkv(1, 256, 8, 8, 80, "bfloat16", 9, cuda_device)
    paths = dict(t_kernel.PATH_LAUNCHES)
    with pytest.raises(ValueError, match="head dims 64, 112 and 128"):
        t_kernel.flash_attention_cuda(q, k, v, causal=True, block_q=256,
                                      block_k=256, body="wgmma")
    assert t_kernel.PATH_LAUNCHES == paths


@pytest.mark.gpu
@pytest.mark.parametrize("H,KV,dh", [(16, 8, 128), (32, 32, 112)],
                         ids=["dh128", "dh112"])
def test_wgmma_dropped_tile_fails_the_check(cuda_device, H, KV, dh):
    """The check catches a fault in the wgmma body: with its 128-key tile 4
    left out, the output leaves the bf16 limits; without, it stays."""
    q, k, v = _qkv(1, 1024, H, KV, dh, "bfloat16", 5, cuda_device)
    want = t_kernel.flash_attention_plain(q, k, v, causal=True)
    _assert_close(t_kernel.flash_attention_cuda(q, k, v, causal=True), want)
    with pytest.raises(AssertionError):
        _assert_close(t_kernel.flash_attention_cuda(
            q, k, v, causal=True, drop_key_tile=4), want)


@pytest.mark.gpu
def test_wgmma_mqa_dropped_tile_fails_flash_check(cuda_device, chip_smoke):
    """granite-34b's MQA (48 query heads on one KV head, dh 128) at S
    2,048: the sound call passes ``chip_smoke.flash_check`` and the call
    with its 128-key tile 8 left out fails it; each counts one launch,
    under "wgmma"."""
    q, k, v = _qkv(1, 2048, 48, 1, 128, "bfloat16", 48, cuda_device)
    want = t_kernel.flash_attention_plain(q, k, v, causal=True)
    shares = []
    for tile in (None, 8):
        paths = dict(t_kernel.PATH_LAUNCHES)
        got = t_kernel.flash_attention_cuda(q, k, v, causal=True,
                                            drop_key_tile=tile)
        torch.cuda.synchronize()
        assert {key: t_kernel.PATH_LAUNCHES[key] - n
                for key, n in paths.items()} == {
            "wgmma": 1, "mma_sync": 0, "fp32_pipes": 0}
        shares.append(chip_smoke.flash_check(got, want)[1])
    assert shares[0] <= 1 < shares[1], shares


@pytest.mark.gpu
@pytest.mark.parametrize("gh", [32, 0, 256, -16],
                         ids=["not-a-divisor", "zero", "over-128",
                              "negative"])
def test_wgmma_entry_refuses_a_bad_packing(cuda_device, gh):
    """The C entry refuses, at G 48, heads a CTA that do not divide G or
    exceed 128 (cudaErrorInvalidValue, 1) and launches nothing: the output
    keeps its sentinel."""
    from repro_torch.kernels.flash_attention import build

    q, k, v = _qkv(1, 256, 48, 1, 128, "bfloat16", 256, cuda_device)
    o = torch.full_like(q, 3.0)
    rc = build.load().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1, 256, 256,
        48, 1, 128, 1, 1, 128 ** -0.5, t_kernel.BODIES["wgmma"], -1, gh,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 1
    assert bool((o == 3.0).all())


@pytest.mark.gpu
def test_bodies_that_cannot_take_the_inputs_raise(cuda_device):
    """A named body that cannot take the inputs raises; nothing falls
    back."""
    q, k, v = _qkv(1, 128, 4, 2, 128, "float32", 7, cuda_device)
    paths = dict(t_kernel.PATH_LAUNCHES)
    blocks = dict(block_q=128, block_k=128)
    for body in ("wgmma", "mma_sync"):
        with pytest.raises(ValueError, match="takes bfloat16"):
            t_kernel.flash_attention_cuda(q, k, v, body=body, **blocks)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    with pytest.raises(ValueError, match="drop_key_tile"):
        t_kernel.flash_attention_cuda(qb, kb, vb, body="mma_sync",
                                      drop_key_tile=0, **blocks)
    assert t_kernel.PATH_LAUNCHES == paths


@pytest.mark.gpu
def test_cuda_wrapper_runs_the_kernel(cuda_device):
    """ops.flash_attention with device=None runs on the card and launches
    the kernel once; the result equals the CPU plain path on the same
    inputs."""
    q, k, v = _qkv(1, 300, 16, 8, 128, "bfloat16", 3, "cpu")
    before = t_kernel.LAUNCHES["flash_attention"]
    got = t_ops.flash_attention(q, k, v)
    assert got.device.type == "cuda"
    assert t_kernel.LAUNCHES["flash_attention"] == before + 1
    want = t_ops.flash_attention(q, k, v, device="cpu")
    _assert_close(got, want)

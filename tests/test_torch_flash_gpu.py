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
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as t_ops  # noqa: E402

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


@pytest.mark.gpu
def test_cuda_flash_kernel_matches_plain(cuda_device, monkeypatch):
    """MHA, GQA and MQA, causal and not, fp32 and bf16, dh 64, 128 (bf16:
    the tensor-core path) and 80 (a width the fp32 pipes pad), ragged
    lengths; each call counts one launch under the body it ran, and the
    fp32-pipe body is also run where the tensor-core one applies."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    for H, KV in ((8, 8), (16, 8), (16, 1)):
        for dtype in ("float32", "bfloat16"):
            for dh in (64, 80, 128):
                for S, causal in ((250, True), (256, False)):
                    q, k, v = _qkv(2, S, H, KV, dh, dtype, S + dh,
                                   cuda_device)
                    qp, kp, vp, bq, bk = t_ops.pad_blocks(q, k, v,
                                                          causal=causal)
                    mma = dtype == "bfloat16" and dh in (64, 128)
                    before = t_kernel.LAUNCHES["flash_attention"]
                    paths = dict(t_kernel.PATH_LAUNCHES)
                    got = t_kernel.flash_attention_cuda(
                        qp, kp, vp, causal=causal, block_q=bq, block_k=bk)
                    fma = t_kernel.flash_attention_cuda(
                        qp, kp, vp, causal=causal, block_q=bq, block_k=bk,
                        fp32_pipes=True)
                    torch.cuda.synchronize()
                    assert t_kernel.LAUNCHES["flash_attention"] == before + 2
                    assert {key: t_kernel.PATH_LAUNCHES[key] - n
                            for key, n in paths.items()} == {
                        "tensor_cores": int(mma), "fp32_pipes": 2 - mma}
                    want = t_kernel.flash_attention_plain(
                        qp, kp, vp, causal=causal, block_q=bq, block_k=bk)
                    _assert_close(got[:, :S], want[:, :S])
                    _assert_close(fma[:, :S], want[:, :S])


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

"""The port's flash attention equals the JAX package's.

On CPU tensors the port's wrapper runs the kernel's plain version (the TPU
kernel's blocked online softmax); it is held against
``repro.kernels.flash_attention`` (the Pallas kernel under
``interpret=True``, as ``tests/test_kernel_flash.py`` runs it) and the
port's materialised-scores oracle against the JAX oracle, on the same
inputs from a seeded numpy RNG.  Tolerances are those of
``tests/test_kernel_flash.py``: 3e-5 in fp32 (sums in another order), 2e-2
in bf16 (one or two bf16 ulps of outputs below 1).  The CUDA kernel itself
is held against the plain version on the card in
``tests/test_torch_flash_gpu.py``."""
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro.kernels.flash_attention import ref_attention_gqa as j_ref  # noqa: E402
from repro.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_gqa as j_gqa)
from repro_torch.configs import CONFIGS  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as t_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as t_ref  # noqa: E402

TOL = {"float32": 3e-5, "bfloat16": 2e-2}


def _qkv(B, Sq, Sk, H, KV, dh, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * 0.5).astype(np.float32)
    return f(B, Sq, H, dh), f(B, Sk, KV, dh), f(B, Sk, KV, dh)


def _jax(arrs, dtype):
    return [jnp.asarray(a).astype(dtype) for a in arrs]


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("H,KV", [(8, 8), (8, 2), (16, 1), (48, 1), (24, 1),
                                  (96, 2), (28, 4)],
                         ids=["mha", "gqa", "mqa", "mqa-G48", "mqa-G24",
                              "G48-KV2", "G7"])
@pytest.mark.parametrize("S", [128, 256, 250])
def test_flash_matches_jax_fp32(H, KV, S):
    arrs = _qkv(2, S, S, H, KV, 64)
    want = j_flash(*_jax(arrs, "float32"), block_q=128, block_k=128)
    got = t_ops.flash_attention(*_torch(arrs, "float32"), block_q=128,
                                block_k=128, device="cpu")
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL["float32"])
    ref = t_ref.ref_attention_gqa(*_torch(arrs, "float32"))
    np.testing.assert_allclose(_np(ref), _np(j_ref(*_jax(arrs, "float32"))),
                               atol=TOL["float32"])
    np.testing.assert_allclose(_np(got), _np(ref), atol=TOL["float32"])


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_plain_matches_pallas_kernel(causal):
    """The plain version against the TPU kernel itself (interpret mode) at
    the same blocks, no wrapper on either side."""
    arrs = _qkv(1, 256, 256, 8, 2, 64, seed=7)
    want = j_gqa(*_jax(arrs, "float32"), causal=causal, block_q=128,
                 block_k=128, interpret=True)
    got = t_kernel.flash_attention_plain(*_torch(arrs, "float32"),
                                         causal=causal, block_q=128,
                                         block_k=128)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL["float32"])


def test_flash_bf16_tolerance():
    arrs = _qkv(1, 256, 256, 4, 2, 128, seed=1)
    want = j_flash(*_jax(arrs, jnp.bfloat16), block_q=128, block_k=128)
    got = t_ops.flash_attention(*_torch(arrs, "bfloat16"), block_q=128,
                                block_k=128, device="cpu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL["bfloat16"])
    ref = t_ref.ref_attention_gqa(*_torch(arrs, "bfloat16"))
    np.testing.assert_allclose(_np(ref), _np(j_ref(*_jax(arrs,
                                                         jnp.bfloat16))),
                               atol=TOL["bfloat16"])
    np.testing.assert_allclose(_np(got), _np(ref), atol=TOL["bfloat16"])


def test_flash_block_size_invariance():
    arrs = _qkv(1, 512, 512, 4, 2, 64, seed=3)
    a = t_ops.flash_attention(*_torch(arrs, "float32"), block_q=128,
                              block_k=128, device="cpu")
    b = t_ops.flash_attention(*_torch(arrs, "float32"), block_q=256,
                              block_k=512, device="cpu")
    np.testing.assert_allclose(_np(a), _np(b), atol=TOL["float32"])
    want = j_flash(*_jax(arrs, "float32"), block_q=256, block_k=512)
    np.testing.assert_allclose(_np(b), _np(want), atol=TOL["float32"])


def test_flash_causality():
    """Changing a future key must not change past outputs."""
    q, k, v = _torch(_qkv(1, 256, 256, 4, 2, 64, seed=4), "float32")
    base = t_ops.flash_attention(q, k, v, block_q=128, block_k=128,
                                 device="cpu")
    k2, v2 = k.clone(), v.clone()
    k2[:, 200] += 7.0
    v2[:, 200] += 7.0
    pert = t_ops.flash_attention(q, k2, v2, block_q=128, block_k=128,
                                 device="cpu")
    np.testing.assert_allclose(_np(base[:, :200]), _np(pert[:, :200]),
                               atol=TOL["float32"])
    assert not np.allclose(_np(base[:, 201:]), _np(pert[:, 201:]))


def test_flash_long_context_streaming():
    """KV much longer than one block, non-causal: the online softmax over
    eight key blocks equals the materialised softmax."""
    arrs = _qkv(1, 128, 1024, 4, 4, 64, seed=5)
    want = j_flash(*_jax(arrs, "float32"), causal=False, block_q=128,
                   block_k=128)
    got = t_ops.flash_attention(*_torch(arrs, "float32"), causal=False,
                                block_q=128, block_k=128, device="cpu")
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL["float32"])
    ref = t_ref.ref_attention_gqa(*_torch(arrs, "float32"), causal=False)
    np.testing.assert_allclose(_np(got), _np(ref), atol=TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qwen3_head_shape(dtype):
    """qwen3-0.6b's heads: 16 query heads over 8 KV heads, dh 128, at the
    wrapper's default blocks and a ragged length."""
    arrs = _qkv(1, 200, 200, 16, 8, 128, seed=6)
    jd = jnp.bfloat16 if dtype == "bfloat16" else dtype
    want = j_flash(*_jax(arrs, jd))
    got = t_ops.flash_attention(*_torch(arrs, dtype), device="cpu")
    assert tuple(got.shape) == (1, 200, 16, 128)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype])


@pytest.mark.parametrize("S", [256, 250])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zamba2_head_shape(dtype, S):
    """zamba2-7b's shared attention: 32 query heads on 32 KV heads, dh 112
    (the wgmma body's two 64-column halves, the second zero-filled past
    column 112), at the wrapper's default blocks, a block multiple and a
    ragged length."""
    arrs = _qkv(1, S, S, 32, 32, 112, seed=112)
    jd = jnp.bfloat16 if dtype == "bfloat16" else dtype
    want = j_flash(*_jax(arrs, jd))
    got = t_ops.flash_attention(*_torch(arrs, dtype), device="cpu")
    assert tuple(got.shape) == (1, S, 32, 112)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype])


def test_non_causal_needs_block_multiple():
    """The JAX wrapper's contract, copied: non-causal with Sk not a block
    multiple raises ValueError (ROADMAP §3 lists it as a reference fault)."""
    arrs = _qkv(1, 250, 250, 4, 2, 64)
    with pytest.raises(ValueError, match="non-causal"):
        j_flash(*_jax(arrs, "float32"), causal=False)
    with pytest.raises(ValueError, match="non-causal"):
        t_ops.flash_attention(*_torch(arrs, "float32"), causal=False,
                              device="cpu")


def test_kernel_checks_blocks_and_shapes():
    q, k, v = _torch(_qkv(1, 250, 250, 4, 2, 64), "float32")
    with pytest.raises(ValueError, match="multiples"):
        t_kernel.flash_attention_gqa(q, k, v, block_q=128, block_k=128)
    with pytest.raises(ValueError, match="H % KV"):
        t_kernel.flash_attention_plain(q[..., :3, :], k, v, block_q=250,
                                       block_k=250)


def test_entry_points_default_to_the_card(monkeypatch):
    """``device=None`` means "cuda": without a card the wrapper raises, and
    the CUDA launcher refuses CPU tensors; the plain path counts no
    launch."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arrs = _qkv(1, 128, 128, 4, 2, 64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_ops.flash_attention(*arrs)
    q, k, v = _torch(arrs, "float32")
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_kernel.flash_attention_cuda(q, k, v, block_q=128, block_k=128)
    before = dict(t_kernel.LAUNCHES)
    t_kernel.flash_attention_gqa(q, k, v, block_q=128, block_k=128)
    assert t_kernel.LAUNCHES == before


@pytest.mark.parametrize("dtype,dh,aligned,body,want", [
    ("bfloat16", 64, True, None, "wgmma"),
    ("bfloat16", 128, True, None, "wgmma"),
    ("bfloat16", 112, True, None, "wgmma"),
    ("float32", 128, True, None, "fp32_pipes"),
    ("bfloat16", 80, True, None, "fp32_pipes"),
    ("bfloat16", 128, False, None, "fp32_pipes"),
    ("bfloat16", 64, True, "mma_sync", "mma_sync"),
    ("bfloat16", 128, True, "fp32_pipes", "fp32_pipes"),
    ("bfloat16", 112, True, "fp32_pipes", "fp32_pipes"),
    ("float32", 80, False, "fp32_pipes", "fp32_pipes"),
], ids=["bf16-64", "bf16-128", "bf16-112", "fp32", "dh80", "unaligned",
        "mma_sync", "fp32_pipes-bf16", "fp32_pipes-dh112",
        "fp32_pipes-fp32"])
def test_select_body(dtype, dh, aligned, body, want):
    """The model path (bf16 at dh 64 / 112 / 128 on aligned bases) takes the
    wgmma body by default, everything else the fp32 pipes; a named body
    that can take the inputs is kept."""
    assert t_kernel.select_body(getattr(torch, dtype), dh, aligned,
                                body) == want


@pytest.mark.parametrize("dtype,dh,aligned,body,match", [
    ("float32", 128, True, "wgmma", "takes bfloat16"),
    ("bfloat16", 80, True, "wgmma", "takes bfloat16"),
    ("bfloat16", 128, False, "wgmma", "unaligned"),
    ("bfloat16", 112, False, "wgmma", "unaligned"),
    ("float32", 64, True, "mma_sync", "takes bfloat16"),
    ("bfloat16", 112, True, "mma_sync", "head dims 64 and 128"),
    ("bfloat16", 128, True, "tensor_cores", "unknown"),
], ids=["wgmma-fp32", "wgmma-dh80", "wgmma-unaligned", "wgmma-dh112-unaligned",
        "mma_sync-fp32", "mma_sync-dh112", "unknown"])
def test_select_body_refuses(dtype, dh, aligned, body, match):
    """A named body that cannot take the inputs raises: nothing falls back
    to another body."""
    with pytest.raises(ValueError, match=match):
        t_kernel.select_body(getattr(torch, dtype), dh, aligned, body)


# (H, KV) of the ten configs, of chip_smoke.py's flash grid and of
# tests/test_torch_flash_gpu.py's wgmma grid
PACKED_HEADS = sorted({(c.n_heads, c.n_kv_heads) for c in CONFIGS.values()}
                      | {(8, 8), (16, 8), (16, 1), (32, 8), (64, 8), (48, 1),
                         (96, 2), (24, 1), (12, 1), (28, 4)})


def _ctas(Sq, positions, chunks):
    return -(-Sq // positions) * chunks


def _steps(Sq, positions, chunks):
    """(CTA, 128-key tile) steps of one (batch, KV head), causal, Sk = Sq:
    a CTA walks the key tiles up to its last position."""
    return chunks * sum(-(-min(q0 + positions, Sq) // 128)
                        for q0 in range(0, Sq, positions))


@pytest.mark.parametrize("H,KV", PACKED_HEADS,
                         ids=[f"{h}-{kv}" for h, kv in PACKED_HEADS])
def test_wgmma_packing_rule(H, KV):
    """``gcd(G, 128)`` heads x ``128 / gcd`` positions a CTA: all 128 rows
    live, the chunks tile G, and at every block-padded length the grid
    holds no more CTAs than the old ``128 // G`` positions x all G heads
    did."""
    G = H // KV
    pk = t_kernel.wgmma_packing(G)
    assert pk.heads == math.gcd(G, 128)
    assert pk.heads * pk.positions == 128
    assert pk.heads * pk.chunks == G
    if 128 % G == 0:
        assert pk == (G, 128 // G, 1)
    for Sq in (128, 256, 512, 1024, 2048, 32768):
        assert (_ctas(Sq, pk.positions, pk.chunks)
                <= _ctas(Sq, 128 // G, 1))


def test_wgmma_packing_granite34b_counts():
    """granite-34b's G 48 at S 2,048: 16 heads x 8 positions, 3 chunks;
    768 CTAs a batch row (1,024 before) and 52,224 steps at B 8 (69,632
    before), the issued products 94% useful."""
    pk = t_kernel.wgmma_packing(48)
    assert pk == (16, 8, 3)
    assert _ctas(2048, pk.positions, pk.chunks) == 768
    assert _ctas(2048, 2, 1) == 1024
    assert 8 * _steps(2048, pk.positions, pk.chunks) == 52224
    assert 8 * _steps(2048, 2, 1) == 69632
    issued = 8 * _steps(2048, 8, 3) * 4 * 128 * 128 * 128
    useful = 4 * 128 * 8 * 48 * 2048 * 2049 / 2
    assert 0.94 <= useful / issued < 0.95


@pytest.mark.parametrize("G,heads", [(48, 32), (48, 0), (48, 256), (7, 2),
                                     (96, 64)],
                         ids=["not-a-divisor", "zero", "over-128", "G7-by-2",
                              "G96-by-64"])
def test_wgmma_packing_refuses(G, heads):
    """Heads a CTA that do not divide G or exceed 128 raise, as the C entry
    refuses them (``cudaErrorInvalidValue``)."""
    with pytest.raises(ValueError, match="divisor of G"):
        t_kernel.wgmma_packing(G, heads)

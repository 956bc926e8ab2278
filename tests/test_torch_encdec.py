"""The port's enc-dec and VLM layers equal the JAX package's: whisper's
sinusoidal positions, M-RoPE, the cross-attention K/V and the
cross-attention itself (forward, decode step and gradients), and the flash
kernel's plain version on non-causal attention at key lengths that are no
block multiple (the model path's ``ops.flash_attention_ragged``).

Inputs from a seeded numpy RNG.  Tolerances: fp32 1e-5 (positions,
projections) and 1e-4 (attention outputs); bf16 2**-5 of the reference's
largest magnitude; gradients 1e-5 (fp32) and 2**-4 (bf16) of each one's
largest magnitude.  The flash plain version is held to the kernel tests'
3e-5 (fp32) and 2e-2 (bf16) against the JAX oracle ``ref_attention_gqa``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.distributed.sharding import split_annotations  # noqa: E402
from repro.kernels.flash_attention.ref import (  # noqa: E402
    ref_attention_gqa as j_ref)
from repro.models import encdec as JE  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as t_ops  # noqa: E402
from repro_torch.models import encdec as TE  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from torch_lm_ref import close, np_, one_torch_thread  # noqa: E402,F401

WHISPER, VLM = "whisper-base", "qwen2-vl-7b"
TOL = {"float32": dict(atol=1e-5), "bfloat16": dict(scale=2 ** -5)}
OUT_TOL = {"float32": dict(atol=1e-4), "bfloat16": dict(scale=2 ** -5)}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 2 ** -4}
FLASH_TOL = {"float32": 3e-5, "bfloat16": 2e-2}


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _cfgs(arch, dtype):
    kw = dict(compute_dtype=dtype, cache_dtype=dtype)
    return j_smoke(arch).replace(**kw), t_smoke(arch).replace(**kw)


def _both(x, dtype):
    """numpy fp32 -> (JAX array, torch tensor) in ``dtype``."""
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            torch.as_tensor(x).to(getattr(torch, dtype)))


def _gqa_params(jcfg, seed=0):
    """One attention block's JAX parameters (its own init) and the port's
    copy."""
    jp, _ = split_annotations(JL.init_gqa(jcfg, jax.random.key(seed)))
    return jp, {k: torch.as_tensor(np.array(v)) for k, v in jp.items()}


# ------------------------------------------------------------ positions ----


@pytest.mark.parametrize("d", [256, 512])
def test_sinusoid(d):
    """Whisper's sinusoid (sines then cosines, ``log(1e4) / (half - 1)``)
    at positions 0-1,499: the encoder's 1,500 frames."""
    pos = np.arange(1500, dtype=np.int32)[None]
    want = np.asarray(JE._sinusoid(jnp.asarray(pos), d))
    got = TE._sinusoid(torch.as_tensor(pos), d)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, 1500, d)
    # fp32 angles of up to 1,499 carry ulps of 1.2e-4, so positions past
    # 64 are held to their rounding; the first 64 (the smoke encoder's)
    # to 1e-5
    np.testing.assert_allclose(got[:, :64].numpy(), want[:, :64], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("dim,sections", [(64, (8, 12, 12)),
                                          (128, (16, 24, 24))])
def test_mrope_cos_sin(dim, sections):
    """M-RoPE's slots take the temporal, height and width positions of
    their sections; positions differ across the three."""
    rng = np.random.default_rng(dim)
    pos3 = rng.integers(0, 300, size=(2, 24, 3)).astype(np.int32)
    for dtype in ("float32", "bfloat16"):
        want = JL.mrope_cos_sin(jnp.asarray(pos3), dim, 1e6, sections,
                                getattr(jnp, dtype))
        got = TL.mrope_cos_sin(torch.as_tensor(pos3), dim, 1e6, sections,
                               getattr(torch, dtype))
        for g, w in zip(got, want):
            assert g.dtype == getattr(torch, dtype)
            assert tuple(g.shape) == (2, 24, dim // 2)
            close(g, w, TOL[dtype], dtype)
    # equal positions in the three sections give plain RoPE
    same = np.repeat(pos3[..., :1], 3, axis=-1)
    a = TL.mrope_cos_sin(torch.as_tensor(same), dim, 1e6, sections,
                         torch.float32)
    b = TL.rope_cos_sin(torch.as_tensor(same[..., 0]), dim, 1e6,
                        torch.float32)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="sum to"):
        TL.mrope_cos_sin(torch.as_tensor(pos3), dim, 1e6, (1, 1, 1),
                         torch.float32)


# ------------------------------------------------------ cross-attention ----


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_kv_and_cross_attn(dtype):
    """``encode_kv`` over 64 encoder states and ``cross_attn_forward`` of 8
    queries over them, through the flash kernel's plain version (and as a
    decode step of one query, through ``_sdpa``)."""
    jcfg, tcfg = _cfgs(WHISPER, dtype)
    jp, tp = _gqa_params(jcfg)
    rng = np.random.default_rng(1)
    jenc, tenc = _both(_rand(rng, 2, 64, 256), dtype)
    jh, th = _both(_rand(rng, 2, 8, 256), dtype)
    jk, jv = JL.encode_kv(jp, jenc, jcfg)
    tk, tv = TL.encode_kv(tp, tenc, tcfg)
    assert tk.dtype == tcfg.cdtype() and tuple(tk.shape) == (2, 64, 2, 64)
    close(tk, jk, TOL[dtype], "k")
    close(tv, jv, TOL[dtype], "v")
    want = JL.cross_attn_forward(jp, jh, jcfg, jk, jv)
    got = TL.cross_attn_forward(tp, th, tcfg, tk, tv)
    close(got, want, OUT_TOL[dtype], "cross")
    want1 = JL.cross_attn_forward(jp, jh[:, :1], jcfg, jk, jv)
    got1 = TL.cross_attn_forward(tp, th[:, :1], tcfg, tk, tv, decode=True)
    close(got1, want1, OUT_TOL[dtype], "decode")


def test_cross_attn_runs_the_flash_kernel_and_decode_does_not(monkeypatch):
    """The full-sequence cross-attention calls the kernel's plain version
    once, with the 64 keys unpadded; a decode step does not call it."""
    _, tcfg = _cfgs(WHISPER, "float32")
    _, tp = _gqa_params(_cfgs(WHISPER, "float32")[0])
    seen = []
    real = t_kernel.flash_attention_plain
    monkeypatch.setattr(t_kernel, "flash_attention_plain", lambda q, k, v,
                        **kw: seen.append((q.shape, k.shape, kw))
                        or real(q, k, v, **kw))
    rng = np.random.default_rng(2)
    enc = torch.as_tensor(_rand(rng, 1, 64, 256))
    k, v = TL.encode_kv(tp, enc, tcfg)
    TL.cross_attn_forward(tp, torch.as_tensor(_rand(rng, 1, 5, 256)), tcfg,
                          k, v)
    assert [(tuple(q), tuple(kk), kw["causal"]) for q, kk, kw in seen] == [
        ((1, 128, 4, 64), (1, 64, 2, 64), False)]
    TL.cross_attn_forward(tp, torch.as_tensor(_rand(rng, 1, 1, 256)), tcfg,
                          k, v, decode=True)
    assert len(seen) == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attn_gradients(dtype):
    """Gradients of the cross-attention (through ``FlashAttention``: the
    kernel's plain version forward, the ``_sdpa`` recompute backward) with
    respect to the queries' input, the encoder states and every weight,
    against ``jax.grad`` of the JAX package's ``encode_kv`` +
    ``cross_attn_forward``: 8 queries over 64 keys, so the backward's
    non-causal mask must be queries x keys, not queries x queries."""
    jcfg, tcfg = _cfgs(WHISPER, dtype)
    jp, tp = _gqa_params(jcfg, seed=3)
    rng = np.random.default_rng(3)
    h, enc, w = _rand(rng, 2, 8, 256), _rand(rng, 2, 64, 256), \
        _rand(rng, 2, 8, 256)
    c = getattr(jnp, dtype)

    def jloss(p, h, enc):
        k, v = JL.encode_kv(p, enc.astype(c), jcfg)
        y = JL.cross_attn_forward(p, h.astype(c), jcfg, k, v)
        return jnp.sum(y.astype(jnp.float32) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jp, jnp.asarray(h),
                                               jnp.asarray(enc))
    tp = {k: t.clone().requires_grad_() for k, t in tp.items()}
    th = torch.as_tensor(h).requires_grad_()
    tenc = torch.as_tensor(enc).requires_grad_()
    k, v = TL.encode_kv(tp, tenc.to(tcfg.cdtype()), tcfg)
    y = TL.cross_attn_forward(tp, th.to(tcfg.cdtype()), tcfg, k, v)
    (y.float() * torch.as_tensor(w)).sum().backward()
    got = ({n: tp[n].grad for n in tp}, th.grad, tenc.grad)
    pairs = [(got[0][n], want[0][n], n) for n in ("wq", "wk", "wv", "wo")]
    pairs += [(got[1], want[1], "h"), (got[2], want[2], "enc")]
    for g, wnt, name in pairs:
        wnt = np_(wnt)
        assert float(np.abs(wnt).max()) > 0, name
        close(g, wnt, dict(scale=GRAD_TOL[dtype]), name)


def test_encoder_self_attention_gradients_at_a_ragged_length():
    """The encoder's non-causal self-attention over 250 frames (no block
    multiple) through ``FlashAttention``: forward and input gradients
    against autograd through the plain oracle."""
    _, tcfg = _cfgs(WHISPER, "float32")
    rng = np.random.default_rng(4)
    q, k, v = (torch.as_tensor(_rand(rng, 1, 250, n, 64, scale=0.5))
               .requires_grad_() for n in (4, 2, 2))
    o = TL.FlashAttention.apply(q, k, v, tcfg, False)
    w = torch.as_tensor(_rand(rng, 1, 250, 4, 64))
    got = torch.autograd.grad((o * w).sum(), (q, k, v))
    want_o = t_ops.ref_attention_gqa(q, k, v, causal=False)
    want = torch.autograd.grad((want_o * w).sum(), (q, k, v))
    np.testing.assert_allclose(o.detach().numpy(), want_o.detach().numpy(),
                               rtol=0, atol=1e-5)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), wnt.numpy(), rtol=0,
                                   atol=1e-5 * float(wnt.abs().max()))


# --------------------------------------- non-causal flash at ragged Sk ----


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sk", [64, 250, 1500])
@pytest.mark.parametrize("Sq", [4, 128, 1500])
def test_plain_flash_non_causal_ragged_keys(Sq, Sk, dtype):
    """The model path's non-causal entry (queries padded, keys as they
    are; the plain version's last key tile the remainder) against the JAX
    oracle, GQA 4/2, dh 64."""
    rng = np.random.default_rng(Sq * 7 + Sk)
    arrs = (_rand(rng, 1, Sq, 4, 64, scale=0.5),
            _rand(rng, 1, Sk, 2, 64, scale=0.5),
            _rand(rng, 1, Sk, 2, 64, scale=0.5))
    want = j_ref(*(jnp.asarray(a).astype(getattr(jnp, dtype))
                   for a in arrs), causal=False)
    got = t_ops.flash_attention_ragged(
        *(torch.as_tensor(a).to(getattr(torch, dtype)) for a in arrs),
        device="cpu")
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == (1, Sq, 4, 64)
    np.testing.assert_allclose(np_(got), np_(want), rtol=0,
                               atol=FLASH_TOL[dtype])


def test_ragged_keys_contract():
    """The kernel's check takes a ragged Sk only without the causal mask;
    the public wrapper keeps the JAX wrapper's non-causal ValueError; keys
    zero-padded to a block multiple under no mask change the result (each
    adds exp(0 - m) to a row's denominator), which is why the model path
    hands the keys over unpadded."""
    rng = np.random.default_rng(5)
    q = torch.as_tensor(_rand(rng, 1, 128, 4, 64, scale=0.5))
    k, v = (torch.as_tensor(_rand(rng, 1, 250, 2, 64, scale=0.5))
            for _ in range(2))
    out = t_kernel.flash_attention_plain(q, k, v, causal=False, block_q=128,
                                         block_k=128)
    with pytest.raises(ValueError, match="multiples"):
        t_kernel.flash_attention_plain(q, k, v, causal=True, block_q=128,
                                       block_k=128)
    with pytest.raises(ValueError, match="non-causal"):
        t_ops.flash_attention(q, k, v, causal=False, device="cpu")
    with pytest.raises(ValueError, match="only non-causal"):
        t_ops.pad_blocks(q, k, v, causal=True, pad_keys=False)
    want = t_ops.ref_attention_gqa(q, k, v, causal=False)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=0, atol=3e-5)
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 6))
    padded = t_kernel.flash_attention_plain(q, pad(k), pad(v), causal=False,
                                            block_q=128, block_k=128)
    assert float((padded - want).abs().max()) > 1e-3

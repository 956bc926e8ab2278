"""The enc-dec and VLM families on the card: non-causal flash attention
over key lengths that are no block multiple (whisper's 1,500 frames) on
the wgmma body and the fp32 pipes against the plain version, and the
whisper and qwen2-vl smoke models' prefill, decode and train steps on the
card against the same code on the CPU, same weights.

It imports no JAX, so it also runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_encdec_gpu.py

Without a card it skips.  Tolerances: each flash launch to
``chip_smoke.py``'s check (max |err| 3e-5 in fp32, 2e-2 in bf16, and in
bf16 each |err| within 2 ulps of |want| + 1/16 of its row's mean |want|);
fp32 models (TF32 off) within 1e-5 of the largest magnitude (and of 1),
the loss and gradient norm of a train step within 1e-4; bf16 logits within
2**-5 of their largest magnitude.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.models import transformer as TFM  # noqa: E402
from repro_torch.models.registry import get_model_fns  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

WHISPER, VLM = "whisper-base", "qwen2-vl-7b"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.fixture
def chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke
    return chip_smoke


def _close(got, want, rel=1e-5, floor=1.0):
    """|got - want| within rel x max(floor, want's largest magnitude)."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    assert got.shape == want.shape
    err = float((got - want).abs().max())
    atol = rel * max(floor, float(want.abs().max()))
    assert err <= atol, (err, atol)


@pytest.mark.gpu
@pytest.mark.parametrize("Sq,Sk", [(1500, 1500), (448, 1500), (4, 1500),
                                   (448, 250), (4, 64), (1500, 64)])
@pytest.mark.parametrize("body,dtype,dh", [
    ("wgmma", "bfloat16", 64), ("wgmma", "bfloat16", 128),
    ("fp32_pipes", "bfloat16", 64), ("fp32_pipes", "float32", 64)])
def test_non_causal_ragged_keys(cuda_device, chip_smoke, Sq, Sk, body,
                                dtype, dh):
    """The model path's non-causal entry (``ops.flash_attention_ragged``:
    queries padded, the keys unpadded) on the body named, against the
    plain version on the same inputs; B 2, GQA 8/2 at dh 64 (whisper's
    heads at G 4) and 28/4 at dh 128 (qwen2-vl's G 7)."""
    H, KV = (8, 2) if dh == 64 else (28, 4)
    g = torch.Generator().manual_seed(Sq + Sk + dh)
    dt = getattr(torch, dtype)
    q, k, v = ((torch.randn((2, S, n, dh), generator=g) * 0.5).to(
        device=cuda_device, dtype=dt) for S, n in ((Sq, H), (Sk, KV),
                                                   (Sk, KV)))
    qp, kp, vp, bq, bk = ops.pad_blocks(q, k, v, causal=False,
                                        pad_keys=False)
    assert kp.shape[1] == Sk
    FK.reset_launches()
    got = FK.flash_attention_cuda(qp, kp, vp, causal=False, block_q=bq,
                                  block_k=bk, body=body)[:, :Sq]
    assert FK.PATH_LAUNCHES[body] == 1
    want = FK.flash_attention_plain(qp, kp, vp, causal=False, block_q=bq,
                                    block_k=bk)[:, :Sq]
    err, share = chip_smoke.flash_check(got, want)
    assert share <= 1, (err, share)
    if body == "wgmma":   # the model path's default on these inputs
        FK.reset_launches()
        again = ops.flash_attention_ragged(q, k, v, device=cuda_device)
        assert FK.PATH_LAUNCHES["wgmma"] == 1
        assert torch.equal(again, got)


@pytest.mark.gpu
def test_padded_keys_fail_the_check(cuda_device, chip_smoke):
    """Keys zero-padded to a block multiple under no mask (each zero key
    adds exp(0 - m) to a row's denominator) fail the check the ragged
    launch passes: the check sees the tail."""
    g = torch.Generator().manual_seed(1536)
    q, k, v = ((torch.randn((2, S, n, 64), generator=g) * 0.5).to(
        device=cuda_device, dtype=torch.bfloat16) for S, n in
        ((1536, 8), (1500, 8), (1500, 8)))
    want = FK.flash_attention_plain(q, k, v, causal=False)
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 36))
    good = chip_smoke.flash_check(FK.flash_attention_cuda(
        q, k, v, causal=False), want)
    bad = chip_smoke.flash_check(FK.flash_attention_cuda(
        q, pad(k), pad(v), causal=False), want)
    assert good[1] <= 1 < bad[1], (good, bad)


def _inputs(chip_smoke, cfg, B, S, seed):
    """Tokens and the family's extra inputs (frames; patches and M-RoPE
    positions on a 4 x 4 grid) on the CPU."""
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    if cfg.family == "encdec":
        return toks, {"frames": torch.randn((B, cfg.enc_frames,
                                             cfg.d_model), generator=g)}
    grid = int(round(cfg.n_patches ** 0.5))
    return toks, {"patch_embeds": torch.randn((B, cfg.n_patches,
                                               cfg.d_model), generator=g),
                  "mrope_pos": torch.as_tensor(
                      chip_smoke.mrope_grid_positions(B, S, grid))}


def _prefill_decode(fns, cfg, params, toks, kw, S, dev):
    """Prefill over ``toks[:, :S]``, then a decode step for each later
    token (teacher-forced; a VLM's steps take their M-RoPE positions) ->
    [the prefill's logits, each step's]."""
    on = lambda d: {k: t.to(dev) for k, t in d.items()}
    mpos = kw.get("mrope_pos")
    first = dict(kw, mrope_pos=mpos[:, :S]) if mpos is not None else kw
    with torch.no_grad():
        logits, pc = fns.prefill(params, cfg, toks[:, :S].to(dev),
                                 **on(first))
        cache = fns.init_cache(cfg, toks.shape[0], toks.shape[1], dev)
        for k, small in pc.items():
            cache[k][tuple(slice(0, n) for n in small.shape)] = small
        out = [logits]
        for n in range(S, toks.shape[1]):
            step = {} if mpos is None else {"mrope_pos":
                                            mpos[:, n:n + 1].to(dev)}
            logits, cache = fns.serve_step(params, cfg, cache,
                                           toks[:, n].to(dev), n, **step)
            out.append(logits)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("arch", [WHISPER, VLM])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_on_card(cuda_device, chip_smoke, arch, dtype):
    """A smoke model's prefill (whisper: 64 frames, 12 tokens; qwen2-vl:
    16 patches and 24 tokens) and 4 decode steps (qwen2-vl's with their
    M-RoPE positions) on the card against the CPU, logits within 1e-5
    (fp32) and 2**-5 (bf16) of their largest magnitude; every prefill
    flash launch on the card (all on wgmma in bf16) against the plain
    version."""
    cfg = smoke_config(arch).replace(compute_dtype=dtype, cache_dtype=dtype)
    fns = get_model_fns(cfg)
    params = fns.init_params(cfg, 0, "cpu")
    pd = tree_map(lambda t: t.to(cuda_device), params)
    S = 12 if arch == WHISPER else 24
    toks, kw = _inputs(chip_smoke, cfg, 2, S + 4, 3)
    want = _prefill_decode(fns, cfg, params, toks, kw, S, "cpu")
    FK.reset_launches()
    captured, restore = chip_smoke.capture_flash(FK)
    try:
        got = _prefill_decode(fns, cfg, pd, toks, kw, S, cuda_device)
    finally:
        restore()
    launches = (cfg.enc_layers + 2 * cfg.n_layers if arch == WHISPER
                else cfg.n_layers)
    assert len(captured) == FK.LAUNCHES["flash_attention"] == launches
    if dtype == "bfloat16":
        assert FK.PATH_LAUNCHES["wgmma"] == launches
    for q, k, v, kw_, o, _ in captured:
        err, share = chip_smoke.flash_check(
            o, FK.flash_attention_plain(q, k, v, **kw_))
        assert share <= 1, (err, share)
    for a, b in zip(got, want):
        _close(a, b, rel=1e-5 if dtype == "float32" else 2 ** -5,
               floor=1.0 if dtype == "float32" else 0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", [WHISPER, VLM])
def test_train_steps_on_card(cuda_device, chip_smoke, arch):
    """Two train steps under ``"dots"`` in fp32 on the card against the
    CPU (whisper on frames, qwen2-vl on an image and text), loss and
    gradient norm within 1e-4; every attention of the forward launches the
    flash kernel, twice a step."""
    cfg = smoke_config(arch).replace(compute_dtype="float32")
    fns = get_model_fns(cfg)
    toks, kw = _inputs(chip_smoke, cfg, 2, 64, 8)
    batch = {"tokens": toks.int(),
             "targets": torch.cat([toks[:, 1:], torch.full((2, 1), -1)],
                                  1).int(), **kw}
    per_forward = (cfg.enc_layers + 2 * cfg.n_layers if arch == WHISPER
                   else cfg.n_layers)
    out = {}
    for dev in ("cpu", cuda_device):
        state = TFM.train_state(fns.init_params(cfg, 0, "cpu"))
        state = tree_map(lambda t: t.to(dev), state)
        step = fns.make_train_step(cfg, AdamWConfig(total_steps=4,
                                                    warmup_steps=1), 1)
        FK.reset_launches()
        out[str(dev)] = []
        for _ in range(2):
            state, m = step(state, batch)
            out[str(dev)].append(m)
        if dev != "cpu":
            assert FK.LAUNCHES["flash_attention"] == 2 * 2 * per_forward
    for a, b in zip(out["cuda"], out["cpu"]):
        for key in ("loss", "grad_norm"):
            assert abs(float(a[key]) / float(b[key]) - 1) <= 1e-4, key
        assert np.isfinite(float(a["loss"]))

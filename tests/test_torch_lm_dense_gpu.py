"""The dense family's granite-8b, qwen3-32b and granite-34b on the card
against the same code on the CPU, same weights: each smoke model's
forward, prefill, cache and decode; prefills at the published head
layouts (granite-34b's 48 query heads on one KV head, qwen3-32b's 64 on 8,
granite-8b's 32 on 8; dh 128, bf16) whose flash launches all run the
wgmma body; and a train step of each smoke model.

It imports no JAX, so it also runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_lm_dense_gpu.py

Without a card it skips.  Tolerances: fp32 (TF32 off) differs from the CPU
only in the order of sums: logits and caches within 1e-5 of their largest
magnitude (and of 1), the loss and gradient norm of a whole train step
within 1e-4; bf16 logits and caches within 2**-5 of their largest
magnitude, the bf16 tolerance of the CPU parity tests; each flash launch
within 2 bf16 ulps + 1/16 of its row's mean |output| of the plain version
and within 2e-2 (``chip_smoke.py``'s two limits).
"""
import math
import os

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.models import transformer as TFM  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.tree import key_paths, tree_map  # noqa: E402

G8, Q32, G34 = "granite-8b", "qwen3-32b", "granite-34b"
ARCHS = (G8, Q32, G34)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _close(got, want, rel, floor=1.0):
    """|got - want| within rel x max(floor, want's largest magnitude)."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    assert got.shape == want.shape
    err = float((got - want).abs().max())
    atol = rel * max(floor, float(want.abs().max()))
    assert err <= atol, (err, atol)


def _tokens(B, S, vocab, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (B, S), generator=g)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_model_on_card(cuda_device, arch, dtype):
    """Forward, prefill (logits and K/V cache) and two decode steps of the
    smoke model on the card against the CPU."""
    cfg = smoke_config(arch).replace(compute_dtype=dtype, cache_dtype=dtype)
    params = TFM.init_params(cfg, 0, "cpu")
    pd = tree_map(lambda t: t.to(cuda_device), params)
    rel, floor = (1e-5, 1.0) if dtype == "float32" else (2 ** -5, 0.0)
    toks = _tokens(2, 40, cfg.vocab_size, 1)
    with torch.no_grad():
        _close(TFM.forward(pd, cfg, toks.to(cuda_device))[0],
               TFM.forward(params, cfg, toks)[0], rel, floor)
        got, cache = TFM.prefill(pd, cfg, toks[:, :24].to(cuda_device))
        want, wcache = TFM.prefill(params, cfg, toks[:, :24])
        _close(got, want, rel, floor)
        for key in wcache:
            assert wcache[key].shape[-2] == cfg.n_kv_heads
            _close(cache[key], wcache[key], rel, floor)
        big, wbig = (TFM.init_cache(cfg, 2, 32, d) for d in (cuda_device,
                                                              "cpu"))
        for b, c in ((big, cache), (wbig, wcache)):
            for key in b:
                b[key][:, :, :24] = c[key]
        for t in (24, 25):
            tok = toks[:, t]
            got, big = TFM.serve_step(pd, cfg, big, tok.to(cuda_device), t)
            want, wbig = TFM.serve_step(params, cfg, wbig, tok, t)
            _close(got, want, rel, floor)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,heads,kv", [(G34, 48, 1), (Q32, 64, 8),
                                           (G8, 32, 8)],
                         ids=["granite-34b", "qwen3-32b", "granite-8b"])
def test_prefill_at_published_heads_runs_wgmma(cuda_device, monkeypatch,
                                               arch, heads, kv):
    """The smoke model at the published head layout and dh 128, bf16 (the
    shapes the served models launch; granite-34b's G 48 leaves the wgmma
    body 2 query positions a CTA): every prefill launch on the wgmma body
    and within both flash limits of the plain version on its own inputs;
    logits and caches within 2**-5 of the CPU's."""
    monkeypatch.syspath_prepend(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    cfg = smoke_config(arch).replace(n_heads=heads, n_kv_heads=kv,
                                     d_head=128, n_layers=2)
    params = TFM.init_params(cfg, 0, "cpu")
    pd = tree_map(lambda t: t.to(cuda_device), params)
    toks = _tokens(2, 256, cfg.vocab_size, 6)
    launch, captured = FK.flash_attention_cuda, []

    def capturing(q, k, v, **kw):
        o = launch(q, k, v, **kw)
        captured.append((q, k, v, kw, o))
        return o

    FK.reset_launches()
    FK.flash_attention_cuda = capturing
    try:
        with torch.no_grad():
            got, cache = TFM.prefill(pd, cfg, toks.to(cuda_device))
    finally:
        FK.flash_attention_cuda = launch
    assert len(captured) == FK.PATH_LAUNCHES["wgmma"] == cfg.n_layers
    assert FK.LAUNCHES["flash_attention"] == cfg.n_layers
    for q, k, v, kw, o in captured:
        assert (q.shape[2], k.shape[2], q.shape[3]) == (heads, kv, 128)
        want = FK.flash_attention_plain(q, k, v, **kw)
        err, share = chip_smoke.flash_check(o, want)
        assert share <= 1, (err, share)
    with torch.no_grad():
        want, wcache = TFM.prefill(params, cfg, toks)
    _close(got, want, 2 ** -5, floor=0.0)
    for key in wcache:
        _close(cache[key], wcache[key], 2 ** -5, floor=0.0)


def _batch(B, S, vocab, seed):
    toks = _tokens(B, S, vocab, seed).int()
    targets = torch.cat([toks[:, 1:], torch.full((B, 1), -1,
                                                 dtype=torch.int32)], 1)
    return {"tokens": toks, "targets": targets}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_on_card(cuda_device, arch):
    """Two train steps under ``"dots"``: fp32 on the card against the CPU,
    loss and gradient norm within 1e-4; then one bf16 step on the card,
    every forward of every layer on the wgmma body, a finite loss and
    every leaf moved."""
    cfg = smoke_config(arch).replace(compute_dtype="float32")
    batch = _batch(2, 128, cfg.vocab_size, 8)
    opt = AdamWConfig(total_steps=4, warmup_steps=1)
    out = {}
    for dev in ("cpu", cuda_device):
        state = TFM.train_state(TFM.init_params(cfg, 0, "cpu"))
        state = tree_map(lambda t: t.to(dev), state)
        step = TFM.make_train_step(cfg, opt, 1)
        FK.reset_launches()
        out[str(dev)] = [step(state, batch)[1] for _ in range(2)]
        if dev != "cpu":
            assert FK.LAUNCHES["flash_attention"] == 2 * 2 * cfg.n_layers
    for a, b in zip(out["cuda"], out["cpu"]):
        assert abs(float(a["loss"]) - float(b["loss"])) <= 1e-4
        assert abs(float(a["grad_norm"]) / float(b["grad_norm"]) - 1) <= 1e-4

    cfg = smoke_config(arch)
    state = TFM.train_state(TFM.init_params(cfg, 0, cuda_device))
    before = {k: v.clone() for k, v in key_paths(state["params"])}
    FK.reset_launches()
    state, m = TFM.make_train_step(cfg, opt, 1)(state, batch)
    assert FK.PATH_LAUNCHES["wgmma"] == FK.LAUNCHES["flash_attention"] \
        == 2 * cfg.n_layers
    assert math.isfinite(float(m["loss"]))
    for key, t in key_paths(state["params"]):
        assert not torch.equal(t, before[key]), key

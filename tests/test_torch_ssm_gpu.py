"""The SSM and hybrid families on the card against the same code on the
CPU, same weights: the Mamba2 layer (forward, its states, decode,
gradients), decode against the forward, a zamba2 smoke model at dh 112
whose shared attention runs the flash kernel's wgmma body, and train
steps of both smoke models.

It imports no JAX, so it also runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_ssm_gpu.py

Without a card it skips.  Tolerances: fp32 (TF32 off) differs from the CPU
only in the order of sums: outputs and states within 1e-5 of their largest
magnitude (and of 1), gradients within 1e-5 of each one's largest
magnitude, the loss and gradient norm of a whole train step within 1e-4;
bf16 logits within 2**-5 of their largest magnitude, the bf16 tolerance of
the CPU parity tests; each flash launch within 2 bf16 ulps + 1/16 of its
row's mean |output| of the plain version (``chip_smoke.py``'s elementwise
check).
"""
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models import transformer as TFM  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.tree import key_paths, tree_map  # noqa: E402

MAMBA, ZAMBA = "mamba2-780m", "zamba2-7b"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _rand(*shape, seed=0, scale=0.5):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g) * scale


def _close(got, want, rel=1e-5, floor=1.0):
    """|got - want| within rel x max(floor, want's largest magnitude)."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    assert got.shape == want.shape
    err = float((got - want).abs().max())
    atol = rel * max(floor, float(want.abs().max()))
    assert err <= atol, (err, atol)


@pytest.mark.gpu
@pytest.mark.parametrize("split", [True, False], ids=["split", "fused"])
def test_ssm_layer_on_card(cuda_device, split):
    """fp32: forward over 3 chunks with its state and conv tail, a
    continuation from that state, 4 decode steps and the gradient of every
    leaf and of the input, card against CPU."""
    cfg = smoke_config(MAMBA).replace(compute_dtype="float32",
                                      ssm_split_proj=split)
    p = SSM.init_ssm(cfg, torch.Generator().manual_seed(1), "cpu")
    pd = tree_map(lambda t: t.to(cuda_device), p)
    h = _rand(2, 96, cfg.d_model, seed=2)
    y, (s, c) = SSM.ssm_forward(p, h, cfg, return_state=True)
    yd, (sd, cd) = SSM.ssm_forward(pd, h.to(cuda_device), cfg,
                                   return_state=True)
    for a, b in ((yd, y), (sd, s), (cd, c)):
        _close(a, b)
    h2 = _rand(2, 32, cfg.d_model, seed=3)
    _close(SSM.ssm_forward(pd, h2.to(cuda_device), cfg, initial_state=sd),
           SSM.ssm_forward(p, h2, cfg, initial_state=s))
    for t in range(4):
        x = _rand(2, 1, cfg.d_model, seed=10 + t)
        y, (s, c) = SSM.ssm_decode(p, x, cfg, s, c)
        yd, (sd, cd) = SSM.ssm_decode(pd, x.to(cuda_device), cfg, sd, cd)
        for a, b in ((yd, y), (sd, s), (cd, c)):
            _close(a, b)
    r = _rand(2, 96, cfg.d_model, seed=4, scale=1.0)
    grads = []
    for params, dev in ((p, "cpu"), (pd, cuda_device)):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        x = h.detach().to(dev).requires_grad_()
        (SSM.ssm_forward(leaves, x, cfg) * r.to(dev)).sum().backward()
        grads.append({"h": x.grad, **{k: v.grad for k, v in leaves.items()}})
    for k in grads[0]:
        _close(grads[1][k], grads[0][k], floor=0.0)


@pytest.mark.gpu
def test_decode_continues_the_forward_on_card(cuda_device):
    """fp32 on the card: a whole model's prefill over 64 tokens, then 8
    decode steps, against one forward over the 72 tokens (the chunked SSD
    and the recurrence are one function), for mamba2 and zamba2."""
    for arch in (MAMBA, ZAMBA):
        cfg = smoke_config(arch).replace(compute_dtype="float32",
                                         cache_dtype="float32", ssm_chunk=8)
        params = TFM.init_params(cfg, 0, cuda_device)
        g = torch.Generator().manual_seed(5)
        toks = torch.randint(0, cfg.vocab_size, (2, 72), generator=g)
        toks = toks.to(cuda_device)
        with torch.no_grad():
            full, _ = TFM.forward(params, cfg, toks)
            logits, cache = TFM.prefill(params, cfg, toks[:, :64])
            if "attn_k" in cache:
                for k in ("attn_k", "attn_v"):
                    big = cache[k].new_zeros((*cache[k].shape[:2], 80,
                                              *cache[k].shape[3:]))
                    big[:, :, :64] = cache[k]
                    cache[k] = big
            _close(logits, full[:, 63], floor=1.0)
            for t in range(64, 72):
                logits, cache = TFM.serve_step(params, cfg, cache,
                                               toks[:, t], t)
                _close(logits, full[:, t], floor=1.0)


@pytest.mark.gpu
def test_hybrid_prefill_dh112_runs_wgmma(cuda_device, monkeypatch):
    """A zamba2 smoke model at d_head 112 and G 1 (zamba2-7b's), bf16: its
    prefill launches the flash kernel once per shared-block application,
    every launch on the wgmma body and equal to the plain version on
    its own inputs (to the limits ``chip_smoke.py`` holds zamba2's to);
    its logits and caches equal the CPU's within
    2**-5."""
    monkeypatch.syspath_prepend(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    cfg = smoke_config(ZAMBA).replace(d_head=112, n_kv_heads=4)
    params = TFM.init_params(cfg, 0, "cpu")
    pd = tree_map(lambda t: t.to(cuda_device), params)
    g = torch.Generator().manual_seed(6)
    toks = torch.randint(0, cfg.vocab_size, (2, 256), generator=g)
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
    apps = TFM.n_shared_apps(cfg)
    assert len(captured) == apps == FK.PATH_LAUNCHES["wgmma"] == 2
    assert FK.PATH_LAUNCHES["fp32_pipes"] == 0
    for q, k, v, kw, o in captured:
        assert q.shape[-1] == 112
        want = FK.flash_attention_plain(q, k, v, **kw)
        err, share = chip_smoke.flash_check(o, want)
        assert share <= 1, (err, share)
    with torch.no_grad():
        want, wcache = TFM.prefill(params, cfg, toks)
    _close(got, want, rel=2 ** -5, floor=0.0)
    for key in wcache:
        _close(cache[key], wcache[key], rel=2 ** -5, floor=0.0)


def _batch(B, S, vocab, seed):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, vocab, (B, S), generator=g, dtype=torch.int32)
    targets = torch.cat([toks[:, 1:], torch.full((B, 1), -1,
                                                 dtype=torch.int32)], 1)
    return {"tokens": toks, "targets": targets}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", [MAMBA, ZAMBA])
def test_train_steps_on_card(cuda_device, arch):
    """Two train steps under ``"dots"``: fp32 on the card against the CPU,
    loss and gradient norm within 1e-4 (zamba2's attention through
    ``FlashAttention`` on the fp32-pipe body); then bf16 on the card, a
    finite loss and every leaf of the layers (and of the shared block)
    moved."""
    cfg = smoke_config(arch).replace(compute_dtype="float32")
    batch = _batch(2, 128, cfg.vocab_size, 8)
    apps = TFM.n_shared_apps(cfg)
    out = {}
    for dev in ("cpu", cuda_device):
        state = TFM.train_state(TFM.init_params(cfg, 0, "cpu"))
        state = tree_map(lambda t: t.to(dev), state)
        step = TFM.make_train_step(cfg, AdamWConfig(total_steps=4,
                                                    warmup_steps=1), 1)
        FK.reset_launches()
        out[str(dev)] = [step(state, batch)[1] for _ in range(2)]
        if dev != "cpu":
            assert FK.LAUNCHES["flash_attention"] == 2 * 2 * apps
    for a, b in zip(out["cuda"], out["cpu"]):
        assert abs(float(a["loss"]) - float(b["loss"])) <= 1e-4
        assert abs(float(a["grad_norm"]) / float(b["grad_norm"]) - 1) <= 1e-4

    cfg = smoke_config(arch)
    state = TFM.train_state(TFM.init_params(cfg, 0, cuda_device))
    before = dict((k, v.clone()) for k, v in key_paths(state["params"]))
    step = TFM.make_train_step(cfg, AdamWConfig(total_steps=4,
                                                warmup_steps=1), 1)
    state, m = step(state, batch)
    assert math.isfinite(float(m["loss"]))
    for key, t in key_paths(state["params"]):
        if key.startswith(("['layers']", "['shared_attn']")):
            assert not torch.equal(t, before[key]), key
    assert np.isfinite(float(m["grad_norm"]))

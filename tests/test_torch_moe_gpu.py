"""The MoE family on the card against the same code on the CPU, same
weights: ``moe_forward`` (routes, tie order, slots and drops), MLA forward
and decode, and train steps of the phi smoke model through
``layers.FlashAttention``.

It imports no JAX, so it also runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_moe_gpu.py

Without a card it skips.  Tolerances: fp32 (TF32 off) differs from the CPU
only in the order of sums, so routes, slot positions and drops are equal
and outputs lie within 1e-5 of the CPU's (1e-4 for the loss and the
gradient norm of a whole train step); bf16 outputs within 2**-5 of their
largest magnitude, the bf16 tolerance of the CPU parity tests.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import transformer as TFM  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

PHI, DSV2 = "phi3.5-moe-42b-a6.6b", "deepseek-v2-lite-16b"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _rand(*shape, seed=0, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g) * scale


def _close(got, want, atol):
    assert got.shape == want.shape
    err = float((got.float().cpu() - want.float()).abs().max())
    assert err <= atol, (err, atol)


@pytest.mark.gpu
@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_moe_forward_on_card(cuda_device, cf):
    """fp32 with ties (experts 1 = 0 and 3 = 2 in the router): the same
    routes, in the same order, the same slots, drops and output as on the
    CPU, at the default capacity and at one that drops."""
    cfg = smoke_config(PHI).replace(compute_dtype="float32",
                                    capacity_factor=cf, n_shared_experts=1)
    p = MOE.init_moe(cfg, torch.Generator().manual_seed(1), "cpu")
    p["router"][:, 1] = p["router"][:, 0]
    p["router"][:, 3] = p["router"][:, 2]
    x = _rand(4, 64, cfg.d_model, seed=2)
    pd = tree_map(lambda t: t.to(cuda_device), p)
    xd = x.to(cuda_device)
    xt, xtd = x.reshape(-1, cfg.d_model), xd.reshape(-1, cfg.d_model)
    _, w, e = MOE.route(p["router"], xt, cfg)
    _, wd, ed = MOE.route(pd["router"], xtd, cfg)
    assert torch.equal(ed.cpu(), e)
    C = MOE.capacity(cfg, xt.shape[0])
    host = MOE._dispatch_local(xt, e, w, cfg.n_experts, C, cfg.d_model,
                               torch.float32)
    card = MOE._dispatch_local(xtd, ed, wd, cfg.n_experts, C, cfg.d_model,
                               torch.float32)
    for name, a, b in zip(("buf", "flat_idx", "keep"), card[:3], host[:3]):
        assert torch.equal(a.cpu(), b), name
    s_host, s_card = {}, {}
    y, aux = MOE.moe_forward(p, x, cfg, stats=s_host)
    yd, auxd = MOE.moe_forward(pd, xd, cfg, stats=s_card)
    assert yd.device.type == "cuda"
    _close(yd, y, 1e-5)
    assert abs(float(auxd) - float(aux)) <= 1e-6
    assert int(s_card["dropped"][0]) == int(s_host["dropped"][0])
    assert (int(s_card["dropped"][0]) > 0) == (cf < 1)


@pytest.mark.gpu
def test_moe_forward_bf16_on_card(cuda_device):
    """bf16 (the configs' default) on the smoke model: every token the
    CPU routes apart from a near tie goes the same way on the card."""
    cfg = smoke_config(PHI)
    p = MOE.init_moe(cfg, torch.Generator().manual_seed(3), "cpu")
    x = _rand(8, 128, cfg.d_model, seed=4).bfloat16()
    pd = tree_map(lambda t: t.to(cuda_device), p)
    y, _ = MOE.moe_forward(p, x, cfg)
    yd, _ = MOE.moe_forward(pd, x.to(cuda_device), cfg)
    probs, _, e = MOE.route(p["router"], x.reshape(-1, cfg.d_model), cfg)
    _, _, ed = MOE.route(pd["router"], x.reshape(-1, cfg.d_model)
                         .to(cuda_device), cfg)
    same = (ed.cpu() == e).all(dim=1)
    srt = torch.sort(probs, dim=1, descending=True)[0]
    gap = (srt[:, 1] - srt[:, 2]) / srt[:, 1]
    assert bool((gap[~same] <= 2 ** -6).all())
    assert float(same.float().mean()) >= 0.99
    yt, ydt = y.reshape(-1, cfg.d_model)[same], yd.cpu().reshape(
        -1, cfg.d_model)[same]
    _close(ydt, yt, 2 ** -5 * float(yt.float().abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_forward_and_decode_on_card(cuda_device, dtype):
    """``mla_forward`` (one pass and query blocks of 16) with its cache,
    then ``mla_decode`` naive and absorbed, on the card against the CPU."""
    cfg = smoke_config(DSV2).replace(compute_dtype=dtype, cache_dtype=dtype)
    p = L.init_mla(cfg, torch.Generator().manual_seed(5), "cpu")
    pd = tree_map(lambda t: t.to(cuda_device), p)
    dt = getattr(torch, dtype)
    h = _rand(2, 48, cfg.d_model, seed=6).to(dt)
    pos = torch.arange(48)[None].expand(2, 48)
    tol = (lambda w: 1e-5) if dtype == "float32" else (
        lambda w: 2 ** -5 * float(w.float().abs().max()))
    for q_chunk in (4096, 16):
        c = cfg.replace(q_chunk=q_chunk)
        y, (ckv, kr) = L.mla_forward(p, h, c, pos, return_kv=True)
        yd, (ckvd, krd) = L.mla_forward(pd, h.to(cuda_device), c,
                                        pos.to(cuda_device), return_kv=True)
        for a, b in ((yd, y), (ckvd, ckv), (krd, kr)):
            _close(a, b, tol(b))
    for absorb in (False, True):
        c = cfg.replace(mla_absorb=absorb)
        caches = [torch.zeros((2, 64, n), dtype=dt) for n in
                  (cfg.kv_lora_rank, cfg.qk_rope_dim)]
        caches[0][:, :48], caches[1][:, :48] = ckv, kr
        dcaches = [t.to(cuda_device) for t in caches]
        x = _rand(2, 1, cfg.d_model, seed=7).to(dt)
        y, _, _ = L.mla_decode(p, x, c, *caches, 48)
        yd, _, _ = L.mla_decode(pd, x.to(cuda_device), c, *dcaches, 48)
        _close(yd, y, tol(y))
        for a, b in zip(dcaches, caches):
            _close(a, b, tol(b))


def _batch(B, S, vocab, seed):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, vocab, (B, S), generator=g, dtype=torch.int32)
    targets = torch.cat([toks[:, 1:], torch.full((B, 1), -1,
                                                 dtype=torch.int32)], 1)
    return {"tokens": toks, "targets": targets}


@pytest.mark.gpu
def test_phi_smoke_train_steps_on_card(cuda_device):
    """Two train steps of the phi smoke model under ``"dots"``: fp32 on
    the card (attention through ``FlashAttention``, the fp32 body) against
    the CPU, loss and gradient norm within 1e-4; bf16 on the card, every
    forward of every layer on the wgmma body, a finite loss with the aux
    term, the router and experts moving."""
    cfg = smoke_config(PHI).replace(compute_dtype="float32")
    batch = _batch(2, 128, cfg.vocab_size, 8)
    out = {}
    for dev in ("cpu", cuda_device):
        state = TFM.train_state(TFM.init_params(cfg, 0, "cpu"))
        state = tree_map(lambda t: t.to(dev), state)
        step = TFM.make_train_step(cfg, AdamWConfig(total_steps=4,
                                                    warmup_steps=1), 1)
        FK.reset_launches()
        out[str(dev)] = [step(state, batch)[1] for _ in range(2)]
        if dev != "cpu":
            assert FK.LAUNCHES["flash_attention"] == 2 * 2 * cfg.n_layers
    for a, b in zip(out["cuda"], out["cpu"]):
        assert abs(float(a["loss"]) - float(b["loss"])) <= 1e-4
        assert abs(float(a["grad_norm"]) / float(b["grad_norm"]) - 1) <= 1e-4

    cfg = smoke_config(PHI)
    state = TFM.train_state(TFM.init_params(cfg, 0, cuda_device))
    before = state["params"]["layers"][0]["moe"]["w2"].clone()
    router = state["params"]["layers"][0]["moe"]["router"].clone()
    step = TFM.make_train_step(cfg, AdamWConfig(total_steps=4,
                                                warmup_steps=1), 1)
    FK.reset_launches()
    state, m = step(state, batch)
    assert FK.PATH_LAUNCHES["wgmma"] == FK.LAUNCHES["flash_attention"] \
        == 2 * cfg.n_layers
    assert math.isfinite(float(m["loss"]))
    moe = state["params"]["layers"][0]["moe"]
    assert bool((moe["w2"] != before).any(dim=(1, 2)).all())
    assert not torch.equal(moe["router"], router)
    with torch.no_grad():
        b = {k: v.to(cuda_device) for k, v in batch.items()}
        full = TFM.loss_fn(state["params"], cfg, b)
        ce = TFM.loss_fn(state["params"], cfg.replace(router_aux_coef=0.0), b)
    assert float(full) > float(ce)

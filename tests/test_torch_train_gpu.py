"""The port's training path on the card: gradients through the flash kernel
equal the plain path's, train steps with the kernel equal those with plain
attention, and a restarted run is bit-identical.

It imports no JAX, so it also runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_train_gpu.py

Without a card it skips.  Tolerances:
- one block's q, k, v and wq, wk, wv gradients through
  ``layers.FlashAttention`` against autograd through ``ref_attention_gqa``
  (bf16): ``chip_smoke.GRAD_TOL`` of each gradient's largest magnitude and
  of its L2 norm (the reasons stand beside the constant);
- per-step losses of three train steps, kernel against plain attention
  (bf16, the smoke model): 3e-3, the bf16 tolerance of the 3-step
  comparison with the JAX package in ``tests/test_torch_train.py``, whose
  attention rounds as the plain path does here;
- the port against itself (remat policies, the restart drill): bit for
  bit.
"""
import os

import pytest

torch = pytest.importorskip("torch")

from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.distributed.fault import FailureInjector  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    ref_attention_gqa)
from repro_torch.launch import train as T  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as TFM  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.tree import key_paths, tree_leaves, tree_unflatten  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_LOSS_TOL = 3e-3


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


def _block(dev, S, seed=0):
    cfg = get_config("qwen3-0.6b").replace(n_layers=1)
    gen = torch.Generator(device=dev).manual_seed(seed)
    blk = TFM.init_params(cfg, gen, dev)["layers"][0]
    h = torch.randn((2, S, cfg.d_model), generator=gen, device=dev) \
        .to(cfg.cdtype())
    return cfg, blk, h


@pytest.mark.gpu
@pytest.mark.parametrize("S", [250, 1024])
def test_attention_grads_through_kernel_match_plain(cuda_device, chip_smoke,
                                                    S):
    """qwen3-0.6b's block (dh 128, 16 query heads over 8 KV heads, G 2),
    B 2, bf16; S 250 pads to the kernel's blocks.  One wgmma launch; the
    gradients of the unpadded q, k, v and of wq, wk, wv within GRAD_TOL of
    the plain path's; a detached kernel output fails the same check."""
    cfg, blk, h = _block(cuda_device, S)
    kernel = lambda q, k, v: L.FlashAttention.apply(q, k, v, cfg, True)
    FK.reset_launches()
    got = chip_smoke.block_attention_grads(cfg, blk, h, kernel)
    assert FK.PATH_LAUNCHES == {"wgmma": 1, "mma_sync": 0, "fp32_pipes": 0}
    want = chip_smoke.block_attention_grads(
        cfg, blk, h, lambda q, k, v: ref_attention_gqa(q, k, v, causal=True))
    shares = chip_smoke.grad_shares(got, want)
    assert all(v <= 1 for v in shares.values()), shares
    detached = chip_smoke.block_attention_grads(
        cfg, blk, h, lambda q, k, v: kernel(q, k, v).detach())
    assert all(float(g.abs().max()) == 0 for g in detached.values())
    assert all(v > 1 for v in chip_smoke.grad_shares(detached, want)
               .values())


@pytest.mark.gpu
def test_flash_forward_is_deterministic(cuda_device):
    """Two launches on the same inputs agree bit for bit: the restart drill
    needs it."""
    cfg, blk, h = _block(cuda_device, 1024, seed=1)
    pos = torch.arange(1024, device=cuda_device)[None].expand(2, 1024)
    qkv = L._qkv(blk["attn"], h, cfg, L._rope(cfg, pos))
    with torch.no_grad():
        a, b = (fops.flash_attention(*qkv, device=cuda_device)
                for _ in range(2))
    assert torch.equal(a, b)


def _smoke(policy=None):
    cfg = smoke_config("qwen3-0.6b")
    return cfg if policy is None else cfg.replace(remat_policy=policy)


@pytest.mark.gpu
def test_train_steps_kernel_match_plain_attention(cuda_device, monkeypatch):
    """Three steps of the smoke model (bf16, dh 64, remat "dots") through
    the wgmma body, twice a step per layer, against the same steps with
    attention on the plain path."""
    cfg = _smoke()
    kw = dict(steps=3, global_batch=4, seq_len=256, log_every=100)
    FK.reset_launches()
    _, got = T.train(cfg, **kw)
    assert FK.PATH_LAUNCHES["wgmma"] == cfg.n_layers * 2 * 3
    assert FK.LAUNCHES["flash_attention"] == cfg.n_layers * 2 * 3
    monkeypatch.setattr(L.FlashAttention, "apply",
                        lambda q, k, v, c, causal: L.sdpa_chunked(
                            q, k, v, c, causal=causal))
    FK.reset_launches()
    _, want = T.train(cfg, **kw)
    assert FK.LAUNCHES["flash_attention"] == 0
    assert all(abs(a - b) <= STEP_LOSS_TOL for a, b in zip(got, want)), (
        got, want)


@pytest.mark.gpu
def test_remat_policies_agree_on_card(cuda_device):
    """"nothing", "dots" and "everything": the same loss and gradients bit
    for bit; the kernel launches once a layer without recompute and twice
    with it."""
    batch = {"tokens": torch.randint(0, 512, (2, 128), device=cuda_device,
                                     generator=torch.Generator(
                                         device=cuda_device).manual_seed(3))}
    batch["targets"] = torch.roll(batch["tokens"], -1, dims=1)
    out = {}
    for policy in ("everything", "dots", "nothing"):
        cfg = _smoke(policy)
        params = TFM.init_params(cfg, 0, cuda_device)
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        FK.reset_launches()
        loss = TFM.loss_fn(tree_unflatten(params, leaves), cfg, batch)
        grads = torch.autograd.grad(loss, leaves)
        forwards = 1 if policy == "everything" else 2
        assert FK.PATH_LAUNCHES["wgmma"] == cfg.n_layers * forwards
        out[policy] = (loss.detach(), grads)
    for policy in ("dots", "nothing"):
        assert torch.equal(out[policy][0], out["everything"][0])
        assert all(torch.equal(a, b) for a, b in
                   zip(out[policy][1], out["everything"][1])), policy


@pytest.mark.gpu
def test_restart_drill_bit_identical_on_card(cuda_device, tmp_path):
    """8 steps straight against a failure at step 5 and a resume from the
    step-3 checkpoint: parameters, moments and step bit for bit."""
    cfg = _smoke()
    kw = dict(steps=8, global_batch=4, seq_len=128, log_every=100,
              opt_cfg=AdamWConfig(lr=1e-3, total_steps=8, warmup_steps=2))
    ref, losses_ref = T.train(cfg, **kw)
    d = str(tmp_path / "ck")
    with pytest.raises(FailureInjector.SimulatedFailure):
        T.train(cfg, ckpt_dir=d, ckpt_every=4, fail_at_step=5, **kw)
    assert ckpt.latest_step(d) == 3
    res, losses_res = T.train(cfg, ckpt_dir=d, ckpt_every=4, resume=True,
                              **kw)
    assert losses_res == losses_ref[4:]
    assert all(t.device.type == "cuda" for t in tree_leaves(res))
    for (k, a), (_, b) in zip(key_paths(ref), key_paths(res)):
        assert torch.equal(a, b), k

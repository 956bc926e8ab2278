"""Expert-parallel MoE on the card: ``moe_forward`` with ``moe_ep`` over a
1 x 4 ("data", "model") mesh of the one card against the capacity path on
the card and against the same EP layer on the CPU.

It imports no JAX, so it also runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_moe_ep_gpu.py

Without a card it skips.  Tolerances: fp32 (TF32 off).  Without slot drops
(capacity factor n_experts / top_k) the EP layer equals the capacity path
within 1e-4, the bound of ``tests/test_dryrun_lowering.py``; the EP layer
on the card equals the EP layer on the CPU within 1e-5 at every factor
(the same slots drop), the order of sums only.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.distributed.sharding import use_mesh  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.tree import key_paths, tree_map  # noqa: E402

PHI = "phi3.5-moe-42b-a6.6b"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the EP path runs on it)")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _setup(cf, shared=1):
    cfg = smoke_config(PHI).replace(
        compute_dtype="float32", n_experts=8, top_k=2, capacity_factor=cf,
        n_shared_experts=shared)
    p = MOE.init_moe(cfg, torch.Generator().manual_seed(4), "cpu")
    x = torch.randn((4, 64, cfg.d_model),
                    generator=torch.Generator().manual_seed(5))
    return cfg, p, x


def _ep(p, x, cfg, dev, stats=None):
    mesh = make_mesh((1, 4), ("data", "model"), devices=[dev] * 4)
    with use_mesh(mesh):
        return MOE.moe_forward(p, x, cfg.replace(moe_ep=True), stats)


def _close(got, want, atol):
    assert got.shape == want.shape
    err = float((got.float().cpu() - want.float().cpu()).abs().max())
    assert err <= atol, (err, atol)


@pytest.mark.gpu
def test_ep_matches_capacity_path_on_card(cuda_device):
    cfg, p, x = _setup(8.0)
    pc, xc = tree_map(lambda t: t.to(cuda_device), p), x.to(cuda_device)
    want, aux_want = MOE.moe_forward(pc, xc, cfg)
    stats = {}
    got, aux = _ep(pc, xc, cfg, cuda_device, stats)
    assert got.device == xc.device and int(stats["dropped"][0]) == 0
    _close(got, want, 1e-4)
    _close(aux, aux_want, 1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("cf", [8.0, 1.0])
def test_ep_on_card_matches_cpu(cuda_device, cf):
    cfg, p, x = _setup(cf)
    st_cpu, st_gpu = {}, {}
    want, aux_want = _ep(p, x, cfg, torch.device("cpu"), st_cpu)
    got, aux = _ep(tree_map(lambda t: t.to(cuda_device), p),
                   x.to(cuda_device), cfg, cuda_device, st_gpu)
    _close(got, want, 1e-5)
    _close(aux, aux_want, 1e-6)
    assert int(st_gpu["dropped"][0]) == int(st_cpu["dropped"][0])
    assert [r["bytes"] for r in st_gpu["collectives"]] == \
        [r["bytes"] for r in st_cpu["collectives"]]


@pytest.mark.gpu
def test_ep_gradients_on_card(cuda_device):
    """Autograd through the shards' copies on the card: the gradients equal
    the capacity path's (no drops)."""
    cfg, p, x = _setup(8.0)
    xc = x.to(cuda_device)
    grads = []
    for ep in (False, True):
        pc = tree_map(lambda t: t.to(cuda_device).requires_grad_(), p)
        y, aux = (_ep(pc, xc, cfg, cuda_device) if ep
                  else MOE.moe_forward(pc, xc, cfg))
        (y.square().sum() + aux).backward()
        grads.append(tree_map(lambda t: t.grad, pc))
    for (key, want), (_, got) in zip(key_paths(grads[0]),
                                     key_paths(grads[1])):
        _close(got, want, 1e-5 * float(want.abs().max()))

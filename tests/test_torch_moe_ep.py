"""The port's expert-parallel MoE (``models/moe.py``: ``moe_forward_ep``)
against the JAX package's ``moe_forward_ep`` and the capacity path.

``smoke_config("phi3.5-moe-42b-a6.6b")`` with 8 experts, top 2, in fp32,
the JAX package's own parameters; a 1 x 4 ("data", "model") mesh: the
port's over the CPU four times, the JAX package's over four host devices
in one subprocess (``--xla_force_host_platform_device_count=4``).

Tolerances.  Against JAX's EP layer within 1e-5 (fp32, the order of sums
only), at capacity factor 8 (no slot drops) and at 1.0 (slots drop per
shard, the same ones); aux within 1e-6.  Against the port's capacity path
within 1e-4 at factor 8, ``tests/test_dryrun_lowering.py``'s bound for
JAX's two paths.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.distributed.sharding import split_annotations  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.distributed.sharding import use_mesh  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.tree import key_paths, tree_map  # noqa: E402
from torch_lm_ref import one_torch_thread  # noqa: E402,F401

ARCH = "phi3.5-moe-42b-a6.6b"
KW = dict(n_experts=8, top_k=2, n_shared_experts=0, compute_dtype="float32")
FACTORS = (8.0, 1.0)
SHAPE = (4, 32)
SRC = os.path.join(os.path.dirname(__file__), "..", "src")

JAX_EP = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json
import jax, jax.numpy as jnp
import numpy as np
from repro.configs import smoke_config
from repro.distributed.sharding import split_annotations, use_mesh
from repro.launch.mesh import make_mesh
from repro.models import moe as MOE
kw, factors, shape, out = json.loads(sys.argv[1])
mesh = make_mesh((1, 4), ("data", "model"))
res = {}
for shared in (0, 1):
    for f in factors:
        cfg = smoke_config("phi3.5-moe-42b-a6.6b").replace(
            **{**kw, "n_shared_experts": shared}, capacity_factor=f,
            moe_ep=True)
        p, _ = split_annotations(MOE.init_moe(cfg, jax.random.key(shared)))
        x = np.random.default_rng(7).standard_normal(
            (*shape, cfg.d_model)).astype(np.float32)
        with mesh, use_mesh(mesh):
            y, aux = jax.jit(lambda p, x: MOE.moe_forward(p, x, cfg))(p, x)
        res[f"y_{shared}_{f}"] = np.asarray(y)
        res[f"aux_{shared}_{f}"] = np.asarray(aux)
np.savez(out, **res)
"""


def _cfgs(factor, shared=0, **kw):
    kw = {**KW, "n_shared_experts": shared, "capacity_factor": factor, **kw}
    return j_smoke(ARCH).replace(**kw), t_smoke(ARCH).replace(**kw)


def _params(jcfg, seed):
    jp, _ = split_annotations(JM.init_moe(jcfg, jax.random.key(seed)))
    return tree_map(torch.as_tensor, jax.tree.map(np.array, jp))


def _x(d_model):
    return torch.as_tensor(np.random.default_rng(7).standard_normal(
        (*SHAPE, d_model)).astype(np.float32))


def _mesh(shape=(1, 4)):
    return make_mesh(shape, ("data", "model"),
                     devices=["cpu"] * int(np.prod(shape)))


def _ep(p, x, tcfg, mesh, stats=None):
    with use_mesh(mesh):
        return TM.moe_forward(p, x, tcfg.replace(moe_ep=True), stats)


@pytest.fixture(scope="module")
def jax_ep(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ep") / "ep.npz")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", JAX_EP,
         json.dumps([KW, FACTORS, SHAPE, out])],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(out))


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("factor", FACTORS)
def test_ep_matches_jax_ep(jax_ep, one_torch_thread, factor, shared):
    jcfg, tcfg = _cfgs(factor, shared)
    p = _params(jcfg, shared)
    y, aux = _ep(p, _x(tcfg.d_model), tcfg, _mesh())
    np.testing.assert_allclose(y.numpy(), jax_ep[f"y_{shared}_{factor}"],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(aux), jax_ep[f"aux_{shared}_{factor}"],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 2), (2, 4)])
def test_ep_matches_capacity_path(one_torch_thread, mesh_shape):
    """No slot drops (factor 8): the EP layer equals the capacity path,
    also with token shards over "data"."""
    jcfg, tcfg = _cfgs(8.0, 1)
    p = _params(jcfg, 3)
    x = _x(tcfg.d_model)
    y0, aux0 = TM.moe_forward(p, x, tcfg)
    y, aux = _ep(p, x, tcfg, _mesh(mesh_shape))
    np.testing.assert_allclose(y.numpy(), y0.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(aux), float(aux0), rtol=0, atol=1e-6)


def test_ep_choice_and_records(one_torch_thread):
    """EP runs only as the JAX package chooses it, and records each
    shard's all-to-alls (the whole [MP, E_loc, C, D] buffer, there and
    back) and its all-gather."""
    jcfg, tcfg = _cfgs(1.0)
    p = _params(jcfg, 0)
    x = _x(tcfg.d_model)
    base, _ = TM.moe_forward(p, x, tcfg)
    for mesh in (None, _mesh((4, 1)), _mesh((1, 3))):       # 8 % 3 != 0
        cfg = tcfg.replace(moe_ep=True)
        if mesh is None:
            y, _ = TM.moe_forward(p, x, cfg)
        else:
            y, _ = _ep(p, x, tcfg, mesh)
        np.testing.assert_array_equal(y.numpy(), base.numpy())
    stats = {}
    _ep(p, x, tcfg, _mesh(), stats)
    E, D, MP = tcfg.n_experts, tcfg.d_model, 4
    C = TM.capacity(tcfg, SHAPE[0] * SHAPE[1] // MP)
    assert stats["capacity"] == [C]
    a2a = [r for r in stats["collectives"] if r["kind"] == "all_to_all"]
    assert len(a2a) == 2 * MP
    for m in range(MP):
        mine = [r["bytes"] for r in a2a if r["shard"] == m]
        assert sum(mine) == 2 * E * C * D * 4
    gathers = [r for r in stats["collectives"] if r["kind"] == "all_gather"]
    assert [r["bytes"] for r in gathers] == \
        [SHAPE[0] * SHAPE[1] // MP * D * 4] * MP
    assert int(stats["dropped"][0]) > 0              # factor 1.0 drops


def test_ep_gradients_match_capacity_path(one_torch_thread):
    """The shards' collectives are tensor copies, so autograd runs through
    the EP layer: its gradients equal the capacity path's (factor 8)."""
    jcfg, tcfg = _cfgs(8.0, 1)
    p0 = _params(jcfg, 5)
    x = _x(tcfg.d_model)
    grads = []
    for ep in (False, True):
        p = tree_map(lambda t: t.clone().requires_grad_(), p0)
        if ep:
            y, aux = _ep(p, x, tcfg, _mesh())
        else:
            y, aux = TM.moe_forward(p, x, tcfg)
        (y.square().sum() + aux).backward()
        grads.append(tree_map(lambda t: t.grad, p))
    for (key, want), (_, got) in zip(key_paths(grads[0]),
                                     key_paths(grads[1])):
        scale = float(want.abs().max())
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * scale, err_msg=key)

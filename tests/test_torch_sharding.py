"""The port's sharding rules (``distributed/sharding.py``) and logical axes
against the JAX package's, at full size for every config.

The JAX side uses ``jax.sharding.AbstractMesh`` (16 x 16 and 2 x 16 x 16:
no devices); the port's meshes are ``launch.mesh.make_production_mesh``'s.
The port keeps stacked layers as lists; its axes tree holds them as the
JAX package does (one dict, a leading None), and ``stack_layers`` gives the
matching meta view, so trees, specs and per-device bytes compare key for
key.
"""
import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

torch = pytest.importorskip("torch")

from repro.configs import ARCH_NAMES, get_config as j_get  # noqa: E402
from repro.distributed import sharding as JS  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models.common import SHAPES as J_SHAPES  # noqa: E402
from repro_torch.configs import get_config as t_get  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.distributed import sharding as TS  # noqa: E402
from repro_torch.launch.mesh import make_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models.common import SHAPES as T_SHAPES  # noqa: E402
from repro_torch.tree import key_paths  # noqa: E402

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def _walk(tree, pre=""):
    """(key path, leaf) with tuples as leaves, for both packages' axes."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{pre}[{k!r}]")
    elif isinstance(tree, list):
        for i, x in enumerate(tree):
            yield from _walk(x, f"{pre}[{i}]")
    else:
        yield pre, tree


def _jax_specs(shardings):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        shardings, is_leaf=lambda x: hasattr(x, "spec"))
    return {jax.tree_util.keystr(k): tuple(v.spec) for k, v in flat}


@pytest.fixture(scope="module", params=ARCH_NAMES)
def states(request):
    arch = request.param
    j_sds, j_axes = JR.abstract_train_state(j_get(arch))
    t_state, t_axes = TR.abstract_train_state(t_get(arch))
    return arch, j_sds, j_axes, t_state, t_axes


def test_axes_trees_equal(states):
    arch, _, j_axes, t_state, t_axes = states
    assert dict(_walk(t_axes)) == dict(_walk(j_axes)), arch
    cfg_j, cfg_t = j_get(arch), t_get(arch)
    for name in ("train_4k", "prefill_32k"):
        assert TR.batch_logical_axes(cfg_t, T_SHAPES[name]) == \
            JR.batch_logical_axes(cfg_j, J_SHAPES[name])
    assert dict(_walk(TR.decode_logical_axes(cfg_t))) == \
        dict(_walk(JR.decode_logical_axes(cfg_j)))


def test_meta_state_shapes_equal(states):
    """The meta state, stacked, has the JAX package's shapes and dtypes
    leaf for leaf, and allocates nothing."""
    arch, j_sds, j_axes, t_state, t_axes = states
    assert all(t.device.type == "meta" for _, t in key_paths(t_state))
    stacked = TS.stack_layers(t_state, t_axes)
    want = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype))
            for k, v in jax.tree_util.tree_flatten_with_path(j_sds)[0]}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in key_paths(stacked)}
    assert got == want, arch


@pytest.mark.parametrize("multi_pod", [False, True])
def test_specs_equal(states, multi_pod):
    arch, j_sds, j_axes, t_state, t_axes = states
    shape, names = MESHES[multi_pod]
    jm = AbstractMesh(shape, names)
    tm = make_production_mesh(multi_pod=multi_pod)
    stacked = TS.stack_layers(t_state, t_axes)
    for fn in ("tree_shardings", "zero_shardings"):
        want = _jax_specs(getattr(JS, fn)(jm, j_sds, j_axes))
        got = {k: tuple(v.spec)
               for k, v in key_paths(getattr(TS, fn)(tm, stacked, t_axes))}
        assert got == want, (arch, fn)


def test_decode_cache_specs_equal(states):
    arch = states[0]
    jm = AbstractMesh(*MESHES[False])
    tm = make_production_mesh()
    for name in ("decode_32k", "long_500k"):
        jd = JR.decode_specs(j_get(arch), J_SHAPES[name])["cache"]
        td = TR.decode_specs(t_get(arch), T_SHAPES[name])["cache"]
        axes = TR.decode_logical_axes(t_get(arch))["cache"]
        for k, v in td.items():
            assert tuple(v.shape) == tuple(jd[k].shape)
            assert TS.spec_for(tm, v.shape, axes[k]) == tuple(
                JS.spec_for(jm, jd[k].shape, axes[k]))


def _device_bytes(mesh, stacked, axes):
    shardings = TS.zero_shardings(mesh, stacked, axes)
    return sum(int(np.prod(s.shard_shape(tuple(t.shape)))) * t.element_size()
               for (_, s), (_, t) in zip(key_paths(shardings),
                                         key_paths(stacked)))


def test_qwen3_32b_zero_state_bytes():
    state, axes = TR.abstract_train_state(t_get("qwen3-32b"))
    stacked = TS.stack_layers(state, axes)
    assert _device_bytes(make_production_mesh(), stacked, axes) \
        == 2_008_363_012


def test_spec_entry_and_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = make_production_mesh(multi_pod=True)
    # batch over pod x data where it divides, pod alone where only it does
    assert TS.spec_entry(mesh, 64, "batch") == ("pod", "data")
    assert TS.spec_entry(mesh, 2, "batch") == "pod"
    assert TS.spec_entry(mesh, 8, "heads") is None        # 8 % 16
    assert TS.spec_entry(mesh, 64, None) is None
    spec = TS.spec_for(mesh, (64, 32, 128), ("batch", None, "heads"))
    assert spec == TS.P(("pod", "data"), None, "model")
    assert TS.placements(mesh, spec) == (Shard(0), Shard(0), Shard(2))
    assert TS.placements(mesh, TS.P()) == (Replicate(),) * 3
    sh = TS.Sharding(mesh, spec)
    assert sh.shard_shape((64, 32, 128)) == (2, 32, 8)
    with pytest.raises(ValueError):
        sh.shard_shape((48, 32, 128))


def test_constrain_is_a_noop_off_a_mesh():
    x = torch.ones(4, 8)
    assert TS.constrain(x, "batch", None) is x
    one = make_mesh((1, 1), ("data", "model"), devices=["cpu"])
    two = make_mesh((2, 1), ("data", "model"), devices=["cpu", "cpu"])
    for mesh in (one, two):        # one device; a plain tensor
        with TS.use_mesh(mesh):
            assert TS._mesh() is mesh
            assert TS.constrain(x, "batch", None) is x
    assert TS._mesh() is None


def test_annotated_records_every_leaf():
    from repro_torch.models import layers as TL
    cfg = t_smoke("qwen3-0.6b")
    gen = torch.Generator().manual_seed(0)
    p, axes = TS.annotated(TL.init_gqa, cfg, gen, "cpu")
    assert axes == {"wq": (None, "heads", None), "wk": (None, "heads", None),
                    "wv": (None, "heads", None), "wo": ("heads", None, None),
                    "q_norm": (None,), "k_norm": (None,)}
    assert isinstance(p["wq"], torch.Tensor)
    with pytest.raises(ValueError):
        TS.annotated(lambda: {"w": torch.ones(3)})
    with pytest.raises(ValueError):
        TS.stack_axes([{"w": (None,)}, {"w": ("ff",)}])


def test_init_train_state_returns_axes_and_tensors():
    """``init_train_state`` gives real tensors with their axes; the meta
    state of the same config has the same leaves."""
    cfg = t_smoke("deepseek-v2-lite-16b")
    state, axes = TR.get_model_fns(cfg).init_train_state(cfg, 0, "cpu")
    meta, meta_axes = TR.abstract_train_state(cfg)
    assert axes == meta_axes
    assert axes["opt"]["m"] == axes["params"] and axes["step"] == ()
    assert [(k, tuple(v.shape), v.dtype) for k, v in key_paths(state)] == \
        [(k, tuple(v.shape), v.dtype) for k, v in key_paths(meta)]
    assert all(v.device.type == "cpu" for _, v in key_paths(state))

"""The port's MoE layer (``models/moe.py``) equals the JAX package's.

``smoke_config("phi3.5-moe-42b-a6.6b")`` (d_model 256, 4 experts, top 2,
d_expert 128) with the JAX package's own parameters
(``moe.init_moe``); inputs from a seeded numpy RNG; the reference is
``_moe_forward_pjit``, the path the JAX package takes without a mesh.

Tolerances.  In fp32 the two differ only in the order of sums: ``y``
within 1e-5 (measured 1.7e-6), aux within 1e-6 (measured 2.4e-7), every
gradient within 1e-5 of its largest magnitude; routes, slot positions,
drops and the dispatch buffer exactly equal.  In bf16 the router products
of XLA and PyTorch round differently in a few logits (73 and 252 of
16,384 x E at phi's and deepseek's full router widths), so routes may
differ only on tokens whose K-th and (K+1)-th probabilities (the JAX
package's) lie within one bf16 ulp; on every other token ``y`` is within
2**-5 of its largest magnitude, the bf16 tolerance of
``tests/test_torch_lm.py``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.distributed.sharding import split_annotations  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro_torch.configs import get_config as t_get  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402
from torch_lm_ref import one_torch_thread  # noqa: E402,F401

ARCH = "phi3.5-moe-42b-a6.6b"
FP32 = dict(y=1e-5, aux=1e-6, grad=1e-5)
BF16_Y = 2 ** -5


def _cfgs(dtype="float32", arch=ARCH, **kw):
    kw = {"compute_dtype": dtype, **kw}
    return j_smoke(arch).replace(**kw), t_smoke(arch).replace(**kw)


def _params(jcfg, seed=0, router=None):
    """The JAX package's MoE parameters (numpy) and the port's (CPU)."""
    jp, _ = split_annotations(JM.init_moe(jcfg, jax.random.key(seed)))
    jp = jax.tree.map(np.array, jp)
    if router is not None:
        jp["router"] = router
    return jp, tree_map(torch.as_tensor, jp)


def _x(shape, seed, dtype):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (jnp.asarray(x).astype(jnp.dtype(dtype)),
            torch.as_tensor(x).to(getattr(torch, dtype)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _jax_route(jp, jcfg, xt):
    """The JAX package's routing lines (``moe.py:63-66``) -> (probs,
    gate_w, gate_e)."""
    c = jcfg.cdtype()
    logits = jnp.einsum("td,de->te", xt, jnp.asarray(jp["router"]).astype(c)
                        ).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    gate_w, gate_e = jax.lax.top_k(probs, jcfg.top_k)
    return probs, gate_w / jnp.sum(gate_w, axis=-1, keepdims=True), gate_e


def _dispatch(jp, jcfg, tp, tcfg, jx, tx):
    """Both packages' dispatch of the same input -> {name: (jax, port)}."""
    D = jcfg.d_model
    xt_j, xt_t = jx.reshape(-1, D), tx.reshape(-1, D)
    T = xt_j.shape[0]
    C = JM.capacity(jcfg, T)
    _, jw, je = _jax_route(jp, jcfg, xt_j)
    _, tw, te = TM.route(tp["router"], xt_t, tcfg)
    jd = JM._dispatch_local(xt_j, je, jw, jcfg.n_experts, C, D,
                            jcfg.cdtype())
    td = TM._dispatch_local(xt_t, te, tw, tcfg.n_experts, C, D,
                            tcfg.cdtype())
    names = ("gate_e", "buf", "flat_idx", "keep")
    return dict(zip(names, ((je, te), (jd[0], td[0]), (jd[1], td[1]),
                            (jd[2], td[2]))))


def _bf16_ulp(x):
    _, e = np.frexp(np.abs(x))
    return np.ldexp(1.0, e - 8)


def _near_ties(probs, k):
    """Tokens whose k-th and (k+1)-th probabilities lie within one bf16
    ulp of the k-th."""
    srt = -np.sort(-np.asarray(probs), axis=-1)
    return srt[:, k - 1] - srt[:, k] <= _bf16_ulp(srt[:, k - 1])


@pytest.mark.parametrize("cf,K,E,T", [
    (1.25, 2, 16, 16384), (1.25, 6, 64, 16384), (1.25, 2, 16, 8),
    (8.0, 2, 16, 4096), (64 / 6, 6, 64, 4160), (0.25, 2, 4, 80),
    (1.0, 1, 2, 1)])
def test_capacity_matches_jax(cf, K, E, T):
    kw = dict(capacity_factor=cf, top_k=K, n_experts=E)
    jcfg, tcfg = _cfgs(**kw)
    assert TM.capacity(tcfg, T) == JM.capacity(jcfg, T)


@pytest.mark.parametrize("shared", [0, 1])
def test_moe_forward_fp32(shared):
    """y, aux, routes, slot positions, drops and the expert buffer against
    ``_moe_forward_pjit``, with and without a shared expert."""
    jcfg, tcfg = _cfgs(n_shared_experts=shared)
    jp, tp = _params(jcfg)
    assert ("shared" in tp) == bool(shared)
    jx, tx = _x((2, 40, jcfg.d_model), 1, "float32")
    want, jaux = JM._moe_forward_pjit(jp, jx, jcfg)
    stats = {}
    got, taux = TM.moe_forward(tp, tx, tcfg, stats=stats)
    assert got.shape == tx.shape and taux.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=FP32["y"])
    assert abs(float(taux) - float(jaux)) <= FP32["aux"]
    for name, (j, t) in _dispatch(jp, jcfg, tp, tcfg, jx, tx).items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                      err_msg=name)
    assert stats == {"dropped": [0], "slots": [160],
                     "capacity": [JM.capacity(jcfg, 80)]}


def test_moe_grads_fp32():
    """Gradients of a weighted sum of y plus the aux loss with respect to
    x, the router and w1 / w2 / w3 against ``jax.grad``."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=2)
    jx, tx = _x((2, 24, jcfg.d_model), 3, "float32")
    wy = np.random.default_rng(4).standard_normal(jx.shape).astype(
        np.float32)

    def j_loss(p, x):
        y, aux = JM._moe_forward_pjit(p, x, jcfg)
        return jnp.sum(y * wy) + aux

    jg = jax.grad(j_loss, argnums=(0, 1))(jax.tree.map(jnp.asarray, jp), jx)
    leaves = {k: tp[k].clone().requires_grad_() for k in
              ("router", "w1", "w2", "w3")}
    x = tx.clone().requires_grad_()
    y, aux = TM.moe_forward(leaves, x, tcfg)
    (torch.sum(y * torch.as_tensor(wy)) + aux).backward()
    pairs = {k: (leaves[k].grad, jg[0][k]) for k in leaves}
    pairs["x"] = (x.grad, jg[1])
    for name, (g, w) in pairs.items():
        w = np.asarray(w)
        assert float(np.abs(w).max()) > 0, name
        np.testing.assert_allclose(_np(g), w, rtol=0,
                                   atol=FP32["grad"] * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exact_ties_route_to_the_lower_expert(dtype):
    """A router with duplicated columns (experts 1 = 0 and 3 = 2) makes
    exact ties decide the route: the port's routes, slots and drops equal
    the JAX package's, where ``torch.topk`` would route otherwise."""
    jcfg, tcfg = _cfgs(dtype)
    router = np.random.default_rng(5).standard_normal(
        (jcfg.d_model, jcfg.n_experts)).astype(np.float32) / 16
    router[:, 1] = router[:, 0]
    router[:, 3] = router[:, 2]
    jp, tp = _params(jcfg, router=router)
    jx, tx = _x((2, 32, jcfg.d_model), 6, dtype)
    got = _dispatch(jp, jcfg, tp, tcfg, jx, tx)
    for name, (j, t) in got.items():
        if name == "buf":
            np.testing.assert_array_equal(_np(t), _np(j), err_msg=name)
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=name)
    probs, _, _ = TM.route(tp["router"], tx.reshape(-1, tcfg.d_model), tcfg)
    assert not torch.equal(torch.topk(probs, tcfg.top_k)[1], got["gate_e"][1])
    want, _ = JM._moe_forward_pjit(jp, jx, jcfg)
    y, _ = TM.moe_forward(tp, tx, tcfg)
    tol = FP32["y"] if dtype == "float32" else BF16_Y * np.abs(_np(want)).max()
    np.testing.assert_allclose(_np(y), _np(want), rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_capacity_drops_match_jax(dtype):
    """capacity_factor 0.25 drops slots: the same slots are kept and
    dropped, and ``stats`` counts the dropped ones."""
    jcfg, tcfg = _cfgs(dtype, capacity_factor=0.25)
    jp, tp = _params(jcfg, seed=7)
    jx, tx = _x((2, 40, jcfg.d_model), 8, dtype)
    d = _dispatch(jp, jcfg, tp, tcfg, jx, tx)
    keep = np.asarray(d["keep"][0])
    np.testing.assert_array_equal(d["keep"][1].numpy(), keep)
    np.testing.assert_array_equal(d["flat_idx"][1].numpy(),
                                  np.asarray(d["flat_idx"][0]))
    stats = {}
    y, _ = TM.moe_forward(tp, tx, tcfg, stats=stats)
    assert int(stats["dropped"][0]) == int((~keep).sum()) > 0
    want, _ = JM._moe_forward_pjit(jp, jx, jcfg)
    tol = FP32["y"] if dtype == "float32" else BF16_Y * np.abs(_np(want)).max()
    np.testing.assert_allclose(_np(y), _np(want), rtol=0, atol=tol)
    dropped_both = ~keep.reshape(-1, jcfg.top_k).any(axis=1)
    assert dropped_both.any()
    assert float(y.reshape(-1, tcfg.d_model)[torch.as_tensor(
        dropped_both)].abs().max()) == 0.0


def test_moe_forward_bf16():
    """bf16 (the configs' default) on 4,096 tokens: routes equal the JAX
    package's except on near ties; y on every other token within 2**-5 of
    its largest magnitude."""
    jcfg, tcfg = _cfgs("bfloat16")
    jp, tp = _params(jcfg, seed=9)
    jx, tx = _x((64, 64, jcfg.d_model), 10, "bfloat16")
    D, K = jcfg.d_model, jcfg.top_k
    probs, _, je = _jax_route(jp, jcfg, jx.reshape(-1, D))
    _, _, te = TM.route(tp["router"], tx.reshape(-1, D), tcfg)
    differ = np.any(np.asarray(je) != te.numpy(), axis=1)
    ties = _near_ties(probs, K)
    assert not (differ & ~ties).any(), np.flatnonzero(differ & ~ties)
    assert differ.mean() <= 0.01, f"{differ.mean():.4%} of tokens differ"
    want, jaux = JM._moe_forward_pjit(jp, jx, jcfg)
    got, taux = TM.moe_forward(tp, tx, tcfg)
    w, g = _np(want).reshape(-1, D), _np(got).reshape(-1, D)
    np.testing.assert_allclose(g[~differ], w[~differ], rtol=0,
                               atol=BF16_Y * np.abs(w).max())
    assert abs(float(taux) - float(jaux)) <= 1e-2


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "deepseek-v2-lite-16b"])
def test_bf16_routes_at_full_router_width(arch):
    """The router alone at the published widths (phi: D 4,096, 16 experts,
    top 2; deepseek: D 2,048, 64 experts, top 6) on 16,384 bf16 tokens:
    about 1% of them tie exactly at the K-th expert; every route equals the
    JAX package's, or differs only on a near tie; ``torch.topk`` would
    route some tied tokens otherwise."""
    jcfg, tcfg = j_get(arch), t_get(arch)
    D, E, K = tcfg.d_model, tcfg.n_experts, tcfg.top_k
    rng = np.random.default_rng(11)
    x = rng.standard_normal((16384, D)).astype(np.float32)
    router = (rng.standard_normal((D, E)) / math.sqrt(D)).astype(np.float32)
    probs, jw, je = _jax_route({"router": router}, jcfg,
                               jnp.asarray(x).astype(jnp.bfloat16))
    tprobs, tw, te = TM.route(torch.as_tensor(router),
                              torch.as_tensor(x).bfloat16(), tcfg)
    je = np.asarray(je)
    ties = _near_ties(probs, K)
    srt = -np.sort(-np.asarray(probs), axis=-1)
    assert (srt[:, K - 1] == srt[:, K]).sum() > 0.004 * len(x)
    differ = np.any(je != te.numpy(), axis=1)
    assert not (differ & ~ties).any(), np.flatnonzero(differ & ~ties)
    assert differ.mean() <= 0.01, f"{differ.mean():.4%} of tokens differ"
    # gate weights from equal probabilities (the tokens whose logits round
    # alike) agree to fp32 rounding
    same = np.abs(tprobs.numpy() - np.asarray(probs)).max(axis=1) <= 1e-6
    assert same.mean() >= 0.98
    np.testing.assert_allclose(tw.numpy()[same], np.asarray(jw)[same],
                               rtol=0, atol=1e-6)
    assert np.any(torch.topk(tprobs, K)[1].numpy() != je)


def test_moe_ep_flag_takes_the_capacity_path():
    """``cfg.moe_ep`` without a mesh: the capacity path, as in the JAX
    package."""
    jcfg, tcfg = _cfgs(moe_ep=True)
    jp, tp = _params(jcfg)
    jx, tx = _x((2, 16, jcfg.d_model), 12, "float32")
    want, _ = JM.moe_forward(jp, jx, jcfg)
    got, _ = TM.moe_forward(tp, tx, tcfg)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=FP32["y"])
    ref, _ = TM.moe_forward(tp, tx, tcfg.replace(moe_ep=False))
    assert torch.equal(got, ref)


def test_init_moe_scales():
    """The JAX package's shapes and init scales, from a seeded
    torch.Generator; the shared expert's width is n_shared x d_expert."""
    cfg = t_smoke("deepseek-v2-lite-16b")
    p = TM.init_moe(cfg, torch.Generator().manual_seed(0), "cpu")
    D, E, Fd = cfg.d_model, cfg.n_experts, cfg.d_expert
    assert tuple(p["router"].shape) == (D, E)
    assert tuple(p["w1"].shape) == tuple(p["w3"].shape) == (E, D, Fd)
    assert tuple(p["w2"].shape) == (E, Fd, D)
    assert abs(float(p["w1"].std()) * D ** 0.5 - 1) < 0.05
    assert abs(float(p["w2"].std()) * Fd ** 0.5 - 1) < 0.05
    assert tuple(p["shared"]["w1"].shape) == (
        D, cfg.n_shared_experts * cfg.d_expert)

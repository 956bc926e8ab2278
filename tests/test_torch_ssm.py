"""The port's Mamba2 layer (``repro_torch.models.ssm``) equals the JAX
package's ``models/ssm.py``.

Config: ``smoke_config("mamba2-780m")`` (d_model 256, d_inner 512, 16 heads
of 32, state 16, conv 4, chunk 32), in both projection layouts (the split
``w_x`` / ``w_B`` / ``w_C`` default and the fused ``w_xbc``), with the JAX
package's own parameters (``init_ssm``) handed over leaf for leaf; inputs
from a seeded numpy RNG.  Compared: ``ssm_forward`` over 2 and 3 chunks,
its returned state and conv tail, a continuation from ``initial_state``,
four ``ssm_decode`` steps, and the gradient of every leaf and of the input.

Tolerances.  fp32: outputs and states within 1e-5 (the two differ in the
order of sums only; measured below 1e-6), gradients within 1e-5 of each
one's largest magnitude.  bf16 (the configs' default): within 2**-5 of the
largest magnitude, as for the dense LM (XLA and PyTorch round elementwise
chains at other places).  The SSM state is fp32 in both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.distributed.sharding import split_annotations  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.tree import key_paths, tree_map  # noqa: E402
from torch_lm_ref import one_torch_thread  # noqa: E402,F401

ARCH = "mamba2-780m"
TOL = {"float32": dict(atol=1e-5), "bfloat16": dict(scale=2 ** -5)}
GRAD_TOL = 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol, msg=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, msg
    atol = tol.get("atol", 0.0) + tol.get("scale", 0.0) * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=msg)


def _h(B, S, D, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal((B, S, D))
            * scale).astype(np.float32)


class Layer:
    """One layout and dtype: both configs, the JAX parameters, the
    port's."""

    def __init__(self, split, dtype):
        kw = dict(ssm_split_proj=split, compute_dtype=dtype,
                  cache_dtype=dtype)
        self.dtype = dtype
        self.jcfg = j_smoke(ARCH).replace(**kw)
        self.tcfg = t_smoke(ARCH).replace(**kw)
        self.jp, _ = split_annotations(JS.init_ssm(self.jcfg,
                                                   jax.random.key(3)))
        self.tp = tree_map(lambda x: torch.as_tensor(np.array(x)), dict(
            jax.tree.map(np.asarray, self.jp)))

    def inputs(self, B, S, seed):
        h = _h(B, S, self.jcfg.d_model, seed)
        c = self.tcfg.cdtype()
        return jnp.asarray(h).astype(self.jcfg.cdtype()), \
            torch.as_tensor(h).to(c)


@pytest.fixture(scope="module", params=[(s, d) for s in (True, False)
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{'split' if p[0] else 'fused'}-{p[1]}")
def layer(request):
    return Layer(*request.param)


def test_init_layout():
    """The port's seeded init has the JAX package's leaves, shapes, dtypes
    and constants, in both layouts."""
    for split in (True, False):
        jcfg = j_smoke(ARCH).replace(ssm_split_proj=split)
        tcfg = t_smoke(ARCH).replace(ssm_split_proj=split)
        jp, _ = split_annotations(JS.init_ssm(jcfg, jax.random.key(0)))
        tp = TS.init_ssm(tcfg, torch.Generator().manual_seed(0), "cpu")
        assert set(tp) == set(jp)
        for k in jp:
            assert tuple(tp[k].shape) == tuple(jp[k].shape), k
            assert str(tp[k].dtype).endswith(str(jp[k].dtype)), k
        for k in ("A_log", "D", "dt_bias", "norm_w"):
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, err_msg=k)
        for k in [k for k in jp if k.startswith("conv_b")]:
            assert not tp[k].any()
        s = 1 / np.sqrt(tcfg.d_model)
        assert tp["w_z"].std().item() == pytest.approx(s, rel=0.05)
        w = tp["conv_w_x" if split else "conv_w"]
        assert w.std().item() == pytest.approx(0.5, rel=0.05)


@pytest.mark.parametrize("S", [64, 96])
def test_forward(layer, S):
    """Output over 2 and 3 chunks of 32."""
    jh, th = layer.inputs(2, S, S)
    want = JS.ssm_forward(layer.jp, jh, layer.jcfg)
    got = TS.ssm_forward(layer.tp, th, layer.tcfg)
    assert got.dtype == layer.tcfg.cdtype()
    _close(got, want, TOL[layer.dtype])


def test_return_and_initial_state(layer):
    """The fp32 state and the conv tail after the last position, and a
    forward continued from that state (on inputs whose conv window starts
    clean, as ``tests/test_ssm_moe.py`` does)."""
    jh, th = layer.inputs(2, 64, 7)
    want, (js, jc) = JS.ssm_forward(layer.jp, jh, layer.jcfg,
                                    return_state=True)
    got, (ts, tc) = TS.ssm_forward(layer.tp, th, layer.tcfg,
                                   return_state=True)
    tol = TOL[layer.dtype]
    _close(got, want, tol)
    assert ts.dtype == torch.float32 and tc.dtype == layer.tcfg.cdtype()
    W = layer.tcfg.ssm_conv
    xbc = layer.tcfg.d_inner + 2 * layer.tcfg.ssm_state
    assert tuple(tc.shape) == (2, W - 1, xbc) == tuple(jc.shape)
    _close(ts, js, tol, "ssm state")
    _close(tc, jc, tol, "conv tail")
    jh2, th2 = layer.inputs(2, 32, 8)
    want, (js2, _) = JS.ssm_forward(layer.jp, jh2, layer.jcfg,
                                    initial_state=js, return_state=True)
    got, (ts2, _) = TS.ssm_forward(layer.tp, th2, layer.tcfg,
                                   initial_state=ts, return_state=True)
    _close(got, want, tol, "continued output")
    _close(ts2, js2, tol, "continued state")


def test_decode_steps(layer):
    """Prefill 32 positions, then 4 one-token steps carrying the state and
    the conv tail."""
    jh, th = layer.inputs(2, 32, 9)
    _, (js, jc) = JS.ssm_forward(layer.jp, jh, layer.jcfg, return_state=True)
    _, (ts, tc) = TS.ssm_forward(layer.tp, th, layer.tcfg, return_state=True)
    steps_j, steps_t = layer.inputs(2, 4, 10)
    tol = TOL[layer.dtype]
    for t in range(4):
        want, (js, jc) = JS.ssm_decode(layer.jp, steps_j[:, t:t + 1],
                                       layer.jcfg, js, jc)
        got, (ts, tc) = TS.ssm_decode(layer.tp, steps_t[:, t:t + 1],
                                      layer.tcfg, ts, tc)
        assert ts.dtype == torch.float32
        _close(got, want, tol, f"step {t}")
        _close(ts, js, tol, f"state {t}")
        _close(tc, jc, tol, f"conv {t}")


@pytest.mark.parametrize("split", [True, False], ids=["split", "fused"])
def test_gradients(split):
    """The gradient of sum(y * r) (r fixed, random) for every parameter
    and for the input, fp32, against ``jax.grad``."""
    lay = Layer(split, "float32")
    jh, th = lay.inputs(2, 64, 11)
    r = _h(2, 64, lay.jcfg.d_model, 12, scale=1.0)

    def jloss(p, h):
        return jnp.sum(JS.ssm_forward(p, h, lay.jcfg) * r)

    jg, jgh = jax.grad(jloss, argnums=(0, 1))(lay.jp, jh)
    tp = {k: v.clone().requires_grad_() for k, v in lay.tp.items()}
    th = th.clone().requires_grad_()
    (TS.ssm_forward(tp, th, lay.tcfg) * torch.as_tensor(r)).sum().backward()
    for k in sorted(jg):
        want = np.asarray(jg[k])
        assert np.abs(want).max() > 0, k
        np.testing.assert_allclose(tp[k].grad.numpy(), want, rtol=0,
                                   atol=GRAD_TOL * np.abs(want).max(),
                                   err_msg=k)
    want = np.asarray(jgh)
    np.testing.assert_allclose(th.grad.numpy(), want, rtol=0,
                               atol=GRAD_TOL * np.abs(want).max())


def test_chunk_rule_raises_in_both():
    """S must be a multiple of min(ssm_chunk, S): 40 over chunks of 32."""
    lay = Layer(True, "float32")
    jh, th = lay.inputs(1, 40, 13)
    with pytest.raises(AssertionError):
        JS.ssm_forward(lay.jp, jh, lay.jcfg)
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        TS.ssm_forward(lay.tp, th, lay.tcfg)
    # shorter than a chunk: one chunk of S
    jh, th = lay.inputs(1, 20, 13)
    _close(TS.ssm_forward(lay.tp, th, lay.tcfg),
           JS.ssm_forward(lay.jp, jh, lay.jcfg), TOL["float32"])


# ------------------------------------------- twins of test_ssm_moe.py ----


def _port_params(cfg, seed=0):
    return TS.init_ssm(cfg, torch.Generator().manual_seed(seed), "cpu")


def test_ssd_chunk_size_invariance():
    cfg8 = t_smoke(ARCH).replace(ssm_chunk=8)
    cfg16 = cfg8.replace(ssm_chunk=16)
    p = _port_params(cfg8)
    h = torch.as_tensor(_h(2, 32, cfg8.d_model, 1))
    f8, f16 = (c.replace(compute_dtype="float32") for c in (cfg8, cfg16))
    # in fp32 the chunking moves only the order of sums
    np.testing.assert_allclose(_np(TS.ssm_forward(p, h, f8)),
                               _np(TS.ssm_forward(p, h, f16)), atol=1e-5)
    h = h.to(cfg8.cdtype())
    y8 = TS.ssm_forward(p, h, cfg8)
    y16 = TS.ssm_forward(p, h, cfg16)
    np.testing.assert_allclose(_np(y8), _np(y16), atol=3e-2)


def test_ssd_state_continuation():
    """forward(x[:,:16]) state feeds forward(x[:,16:]) == forward(x), with a
    clean conv boundary."""
    cfg = t_smoke(ARCH).replace(ssm_chunk=8)
    p = _port_params(cfg)
    h = torch.as_tensor(_h(2, 32, cfg.d_model, 2)).to(cfg.cdtype())
    h2 = h.clone()
    h2[:, 16 - (cfg.ssm_conv - 1):16] = 0.0
    _, (state1b, _) = TS.ssm_forward(p, h2[:, :16], cfg, return_state=True)
    y2, (state2, _) = TS.ssm_forward(p, h2[:, 16:], cfg,
                                     initial_state=state1b,
                                     return_state=True)
    y_ref, (state_ref, _) = TS.ssm_forward(p, h2, cfg, return_state=True)
    np.testing.assert_allclose(_np(y2), _np(y_ref[:, 16:]), atol=3e-2)
    np.testing.assert_allclose(_np(state2), _np(state_ref), atol=3e-2)


def test_ssd_decay_is_contractive():
    """With A < 0 the recurrence decays: zero input -> the state shrinks."""
    cfg = t_smoke(ARCH)
    p = _port_params(cfg)
    B = 2
    state = torch.ones((B, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state))
    conv = torch.zeros((B, cfg.ssm_conv - 1,
                        cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state))
    h = torch.zeros((B, 1, cfg.d_model), dtype=cfg.cdtype())
    _, (new_state, _) = TS.ssm_decode(p, h, cfg, state, conv)
    assert float(new_state.abs().max()) <= 1.0 + 1e-5


# ------------------------------------------------------ the port alone ----


def test_decode_continues_the_forward():
    """fp32: a forward over 32 positions, then 8 decode steps, equals one
    forward over the 40 positions at those positions (the chunked SSD and
    the recurrence are the same function)."""
    cfg = t_smoke(ARCH).replace(compute_dtype="float32", ssm_chunk=8)
    p = _port_params(cfg, 4)
    h = torch.as_tensor(_h(2, 40, cfg.d_model, 14))
    full = TS.ssm_forward(p, h, cfg)
    _, (state, conv) = TS.ssm_forward(p, h[:, :32], cfg, return_state=True)
    for t in range(32, 40):
        y, (state, conv) = TS.ssm_decode(p, h[:, t:t + 1], cfg, state, conv)
        np.testing.assert_allclose(_np(y[:, 0]), _np(full[:, t]), atol=1e-5)


def test_softplus_is_jax_softplus():
    """The port's softplus is log(1 + e^x) everywhere, as
    ``jax.nn.softplus``, to an ulp (the two take log1p from other
    libraries); ``F.softplus`` returns x itself above 20, which in fp32
    is the same number (e^-20 is below half an ulp of 20)."""
    x = np.array([-30.0, -4.6, 0.0, 3.0, 19.9, 20.1, 25.0, 60.0], np.float32)
    got = TS._softplus(torch.as_tensor(x)).numpy()
    want = np.asarray(jax.nn.softplus(x))
    np.testing.assert_allclose(got, want, rtol=2 ** -23, atol=0)
    np.testing.assert_array_equal(got[4:], want[4:])
    np.testing.assert_array_equal(
        torch.nn.functional.softplus(torch.as_tensor(x)).numpy()[4:],
        want[4:])


def test_only_the_projections_are_unbatched_products():
    """The ``"dots"`` remat policy saves ``aten.mm`` outputs: in the SSM
    layer those must be the projections alone (z, x, B, C, dt, out), each
    over the B x S tokens; every SSD product is a batched ``bmm``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func in (torch.ops.aten.mm.default,
                        torch.ops.aten.addmm.default,
                        torch.ops.aten.bmm.default):
                self.ops.append((func, tuple(out.shape)))
            return out

    cfg = t_smoke(ARCH)
    p = _port_params(cfg)
    h = torch.as_tensor(_h(2, 64, cfg.d_model, 15)).to(cfg.cdtype())
    with Record() as rec:
        TS.ssm_forward(p, h, cfg)
    mm = [s for f, s in rec.ops if f is not torch.ops.aten.bmm.default]
    di, N, H, D = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.d_model
    assert sorted(mm) == sorted([(128, di), (128, di), (128, N), (128, N),
                                 (128, H), (128, D)])
    assert sum(f is torch.ops.aten.bmm.default for f, _ in rec.ops) == 4


def test_params_map_leaf_for_leaf(layer):
    for key, t in key_paths(layer.tp):
        np.testing.assert_array_equal(
            t.numpy(), np.asarray(layer.jp[key[2:-2]]), err_msg=key)
    assert len(key_paths(layer.tp)) == len(jax.tree.leaves(layer.jp))

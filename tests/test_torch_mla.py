"""The port's MLA attention (``models/layers.py``: ``init_mla``,
``mla_forward``, ``mla_decode``) equals the JAX package's.

``smoke_config("deepseek-v2-lite-16b")`` (d_model 256, 4 heads,
kv_lora_rank 64, rope dim 16, nope dim 32, value dim 32) with the JAX
package's own parameters (``layers.init_mla``); inputs from a seeded numpy
RNG.

Tolerances, as in ``tests/test_torch_lm.py``: in fp32 the two differ only
in the order of sums, outputs and caches within 1e-5 (measured 1.9e-6 on
cache entries up to 4); in bf16 (the configs' default) XLA and PyTorch
round elementwise chains at other places, every entry within 2**-5 of the
tensor's largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.distributed.sharding import split_annotations  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402
from torch_lm_ref import one_torch_thread  # noqa: E402,F401

ARCH = "deepseek-v2-lite-16b"
TOL = {"float32": dict(out=dict(atol=1e-5), cache=dict(atol=1e-5)),
       "bfloat16": dict(out=dict(scale=2 ** -5), cache=dict(scale=2 ** -5))}


def _cfgs(dtype, **kw):
    kw = {"compute_dtype": dtype, "cache_dtype": dtype, **kw}
    return j_smoke(ARCH).replace(**kw), t_smoke(ARCH).replace(**kw)


def _params(jcfg, seed=0):
    jp, _ = split_annotations(JL.init_mla(jcfg, jax.random.key(seed)))
    jp = jax.tree.map(np.array, jp)
    return jp, tree_map(torch.as_tensor, jp)


def _x(shape, seed, dtype):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (jnp.asarray(x).astype(jnp.dtype(dtype)),
            torch.as_tensor(x).to(getattr(torch, dtype)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    atol = tol.get("atol", 0.0) + tol.get("scale", 0.0) * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _pos(B, S):
    p = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    return jnp.asarray(p), torch.as_tensor(p.copy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,q_chunk", [(40, 4096), (48, 16)])
def test_mla_forward_and_cache(dtype, S, q_chunk):
    """Output and the ``return_kv`` cache (the normed latent, the rotated
    rope key) in one pass (S <= q_chunk) and in query blocks of 16."""
    jcfg, tcfg = _cfgs(dtype, q_chunk=q_chunk)
    jp, tp = _params(jcfg)
    jh, th = _x((2, S, jcfg.d_model), 1, dtype)
    jpos, tpos = _pos(2, S)
    want, (jc, jr) = JL.mla_forward(jp, jh, jcfg, jpos, return_kv=True)
    got, (tc, tr) = TL.mla_forward(tp, th, tcfg, tpos, return_kv=True)
    assert got.dtype == tcfg.cdtype() and tc.dtype == getattr(torch, dtype)
    assert tuple(tc.shape) == (2, S, tcfg.kv_lora_rank)
    assert tuple(tr.shape) == (2, S, tcfg.qk_rope_dim)
    _close(got, want, TOL[dtype]["out"])
    _close(tc, jc, TOL[dtype]["cache"])
    _close(tr, jr, TOL[dtype]["cache"])
    assert torch.equal(TL.mla_forward(tp, th, tcfg, tpos), got)


def test_mla_forward_q_chunk_must_divide():
    _, tcfg = _cfgs("float32", q_chunk=16)
    _, tp = _params(_cfgs("float32")[0])
    _, th = _x((1, 40, tcfg.d_model), 2, "float32")
    with pytest.raises(ValueError, match="multiple of q_chunk"):
        TL.mla_forward(tp, th, tcfg, _pos(1, 40)[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("absorb", [False, True])
def test_mla_decode(dtype, absorb):
    """One token against a 24-row cache holding 11 rows: output and both
    caches (row 11 written, in place in the port) against ``mla_decode``,
    naive and absorbed."""
    jcfg, tcfg = _cfgs(dtype, mla_absorb=absorb)
    jp, tp = _params(jcfg, seed=3)
    B, Smax, n = 2, 24, 11
    rng = np.random.default_rng(4)
    ckv = np.zeros((B, Smax, jcfg.kv_lora_rank), np.float32)
    kr = np.zeros((B, Smax, jcfg.qk_rope_dim), np.float32)
    ckv[:, :n] = rng.standard_normal((B, n, jcfg.kv_lora_rank))
    kr[:, :n] = rng.standard_normal((B, n, jcfg.qk_rope_dim))
    jh, th = _x((B, 1, jcfg.d_model), 5, dtype)
    cd = getattr(torch, dtype)
    want, jc, jr = JL.mla_decode(jp, jh, jcfg,
                                 jnp.asarray(ckv).astype(jnp.dtype(dtype)),
                                 jnp.asarray(kr).astype(jnp.dtype(dtype)),
                                 jnp.int32(n))
    tc, tr = torch.as_tensor(ckv).to(cd), torch.as_tensor(kr).to(cd)
    got, tc2, tr2 = TL.mla_decode(tp, th, tcfg, tc, tr, n)
    assert tc2 is tc and tr2 is tr
    _close(got, want, TOL[dtype]["out"])
    _close(tc, jc, TOL[dtype]["cache"])
    _close(tr, jr, TOL[dtype]["cache"])
    assert float(tc[:, n + 1:].abs().max()) == 0.0


def test_mla_decode_equals_forward_fp32():
    """The port against itself: prefill 15 tokens through ``mla_forward``'s
    cache, then decode token 16 on both paths: the same output as one
    forward over 16 tokens (fp32)."""
    _, tcfg = _cfgs("float32")
    _, tp = _params(_cfgs("float32")[0], seed=6)
    _, th = _x((2, 16, tcfg.d_model), 7, "float32")
    full = TL.mla_forward(tp, th, tcfg, _pos(2, 16)[1])
    _, (c, r) = TL.mla_forward(tp, th[:, :15], tcfg, _pos(2, 15)[1],
                               return_kv=True)
    for absorb in (False, True):
        ckv = torch.zeros((2, 20, tcfg.kv_lora_rank))
        kr = torch.zeros((2, 20, tcfg.qk_rope_dim))
        ckv[:, :15], kr[:, :15] = c, r
        y, _, _ = TL.mla_decode(tp, th[:, 15:], tcfg.replace(
            mla_absorb=absorb), ckv, kr, 15)
        np.testing.assert_allclose(y.numpy(), full[:, 15:].numpy(), rtol=0,
                                   atol=1e-5)


def test_init_mla_shapes_and_scales():
    cfg = t_smoke(ARCH)
    p = TL.init_mla(cfg, torch.Generator().manual_seed(0), "cpu")
    D, H, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    nd, rd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    shapes = {"wq": (D, H, nd + rd), "w_dkv": (D, r), "w_kr": (D, rd),
              "kv_norm": (r,), "w_uk": (r, H, nd), "w_uv": (r, H, vd),
              "wo": (H, vd, D)}
    assert {k: tuple(v.shape) for k, v in p.items()} == shapes
    assert float(p["kv_norm"].min()) == float(p["kv_norm"].max()) == 1.0
    assert abs(float(p["w_uk"].std()) * r ** 0.5 - 1) < 0.05
    assert abs(float(p["wo"].std()) * (H * vd) ** 0.5 - 1) < 0.05

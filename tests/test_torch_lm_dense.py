"""The port's dense family at the three configs that ``tests/test_torch_lm.py``
does not hold (granite-8b, granite-34b, qwen3-32b) equals the JAX
package's, whole model: the torch twins of ``tests/test_models_smoke.py``'s
forward, decode and train-step cases for these archs.

Models: ``smoke_config`` of each (4 layers, d 256, vocab 512, untied
embeddings): granite-8b GQA 4/2 with SwiGLU; qwen3-32b GQA 4/2 with
``qk_norm`` and ``rope_theta`` 1e6; granite-34b MQA (4 query heads on one
KV head) with the plain, non-gated GELU MLP (``w_in`` / ``w_out``).
Parameters are the JAX package's own (``init_train_state``), handed over
by ``params_from_reference``; tokens from a seeded numpy RNG.

Tolerances are the dense tests' (``tests/test_torch_lm.py``,
``tests/test_torch_train.py``): logits within 1e-4 (fp32) and 2**-5 of
the largest magnitude (bf16); caches within 1e-5 / 2**-5; the loss within
1e-5 / 1e-3; every gradient within 1e-5 / 2**-4 of its largest magnitude;
``grad_norm`` within 1e-5 / 2**-5 relative; greedy tokens equal in fp32.
The JAX package's results are jitted and computed once per arch and dtype
(``tests/torch_lm_ref.py``); the launchers run in one subprocess.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.launch.serve import BatchServer as JServer  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import registry as j_registry  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.common import ShapeSpec as JShape  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro_torch.configs import get_config as t_get  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import registry as t_registry  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.common import ShapeSpec  # noqa: E402
from repro_torch.optim import adamw as t_adamw  # noqa: E402
from repro_torch.tree import key_paths, tree_leaves  # noqa: E402
from torch_lm_ref import (SRC, close, jax_grads, jax_params,  # noqa: E402
                          jit_call, launcher_cases, lm_batch, memo,
                          n_port_leaves, one_torch_thread, port_grads,
                          port_key, run_launchers, scalar_close, tokens)

G8, Q32, G34 = "granite-8b", "qwen3-32b", "granite-34b"
ARCHS = (G8, Q32, G34)
TOL = {"float32": dict(logits=dict(atol=1e-4), cache=dict(atol=1e-5),
                       loss=1e-5, grad=1e-5, gnorm=1e-5),
       "bfloat16": dict(logits=dict(scale=2 ** -5), cache=dict(scale=2 ** -5),
                        loss=1e-3, grad=2 ** -4, gnorm=2 ** -5)}
# published parameter counts (``param_count``, vocab padded to 128), and
# each config's head layout and MLP
PUBLISHED = {G8: (8254685184, 36, 4096, 32, 8, True, False),
             Q32: (32763412480, 64, 5120, 64, 8, True, True),
             G34: (33962360832, 88, 6144, 48, 1, False, False)}


@pytest.fixture
def chip_smoke(monkeypatch):
    """``chip_smoke.py`` at the repo's root, the module the card runs."""
    monkeypatch.syspath_prepend(os.path.dirname(SRC))
    import chip_smoke
    return chip_smoke


def _cfgs(arch, dtype):
    kw = dict(compute_dtype=dtype, cache_dtype=dtype)
    return j_smoke(arch).replace(**kw), t_smoke(arch).replace(**kw)


class Pair:
    """One arch and dtype: both configs, the JAX parameters and the
    port's."""

    def __init__(self, arch, dtype):
        self.arch, self.dtype = arch, dtype
        self.jcfg, self.tcfg = _cfgs(arch, dtype)
        self.jp = jax_params(self.jcfg, arch)
        self.tp = TT.params_from_reference(
            jax.tree.map(np.asarray, self.jp), device="cpu")

    def jax(self, name, fn):
        """``fn()``, once per arch, dtype and name."""
        return memo((self.arch, self.dtype, name), fn)


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    return Pair(*request.param)


# ----------------------------------------------------------- the model ----


def test_params_from_reference(pair):
    """Every JAX leaf arrives bit for bit, ``layers`` unstacked; the
    unembedding is its own matrix; the MLP is SwiGLU (``w1`` / ``w3`` /
    ``w2``) or, for granite-34b, the plain ``w_in`` / ``w_out``; K and V
    project to ``n_kv_heads`` (one for MQA); ``q_norm`` / ``k_norm`` only
    with ``qk_norm``."""
    cfg = pair.tcfg
    assert len(pair.tp["layers"]) == cfg.n_layers == 4
    assert "unembed" in pair.tp and not cfg.tie_embeddings
    assert len(key_paths(pair.tp)) == n_port_leaves(pair.jp)
    for key, t in key_paths(pair.tp):
        np.testing.assert_array_equal(t.numpy(), port_key(pair.jp, key),
                                      err_msg=key)
    for blk in pair.tp["layers"]:
        want = {"w1", "w2", "w3"} if cfg.mlp_gated else {"w_in", "w_out"}
        assert set(blk["mlp"]) == want
        assert tuple(blk["attn"]["wk"].shape) == (cfg.d_model,
                                                  cfg.n_kv_heads, cfg.d_head)
        assert ("q_norm" in blk["attn"]) == cfg.qk_norm
    assert cfg.n_kv_heads == (1 if pair.arch == G34 else 2)


def test_forward(pair):
    """Forward logits (the twin of ``test_forward_shapes_no_nan``)."""
    toks = tokens(2, 40, 1)
    want, _ = pair.jax("forward", lambda: jit_call(
        JT.forward, pair.jcfg, pair.jp, jnp.asarray(toks)))
    got, aux = TT.forward(pair.tp, pair.tcfg, torch.as_tensor(toks).long())
    assert tuple(got.shape) == (2, 40, pair.tcfg.vocab_padded)
    assert got.dtype == pair.tcfg.cdtype() and float(aux) == 0.0
    assert bool(torch.isfinite(got).all())
    close(got, want, TOL[pair.dtype]["logits"])


def _jax_prefill(pair, B, S, seed):
    toks = tokens(B, S, seed)
    return toks, pair.jax(f"prefill{B}x{S}", lambda: jit_call(
        JT.prefill, pair.jcfg, pair.jp, jnp.asarray(toks)))


def test_prefill_and_cache(pair):
    """Prefill logits and the K/V cache ([B, S, KV, dh]: one KV head for
    granite-34b)."""
    toks, (want, jc) = _jax_prefill(pair, 3, 37, 2)
    got, tc = TT.prefill(pair.tp, pair.tcfg, torch.as_tensor(toks).long())
    assert got.dtype == torch.float32
    close(got, want, TOL[pair.dtype]["logits"])
    assert set(tc) == set(jc) == {"k", "v"}
    for key in jc:
        assert tuple(tc[key].shape) == tuple(jc[key].shape) == (
            4, 3, 37, pair.tcfg.n_kv_heads, 64), key
        assert tc[key].dtype == getattr(torch, pair.dtype), key
        close(tc[key], jc[key], TOL[pair.dtype]["cache"], key)


def test_serve_step(pair):
    """Prefill 20 tokens into a 32-row cache, then two decode steps:
    logits and cache (the twin of ``test_decode_step``)."""
    toks, (_, jpc) = _jax_prefill(pair, 2, 20, 3)

    def jax_steps():
        jc = JT.init_cache(pair.jcfg, 2, 32)
        jc = {k: jax.lax.dynamic_update_slice_in_dim(v, jpc[k], 0, axis=2)
              for k, v in jc.items()}
        step = jax.jit(lambda p, c, t, n: JT.serve_step(p, pair.jcfg, c, t,
                                                        n))
        out = []
        for i, tok in enumerate(([5, 300], [17, 2])):
            logits, jc = step(pair.jp, jc, jnp.asarray(tok, jnp.int32),
                              jnp.int32(20 + i))
            out.append((logits, jc))
        return out

    want = pair.jax("serve_step", jax_steps)
    _, pc = TT.prefill(pair.tp, pair.tcfg, torch.as_tensor(toks).long())
    tc = TT.init_cache(pair.tcfg, 2, 32, device="cpu")
    t_serve.BatchServer._splice(tc, pc)
    tol = TOL[pair.dtype]
    for i, tok in enumerate(([5, 300], [17, 2])):
        got, tc = TT.serve_step(pair.tp, pair.tcfg, tc, torch.tensor(tok),
                                20 + i)
        jl, jc = want[i]
        assert tuple(got.shape) == (2, pair.tcfg.vocab_padded)
        close(got, jl, tol["logits"], f"step {i}")
        for key in tc:
            assert tuple(tc[key].shape) == tuple(jc[key].shape), key
            close(tc[key], jc[key], tol["cache"], key)


def _grads(pair, batch):
    return pair.jax("grads", lambda: jax_grads(JT.loss_fn, pair.jp,
                                               pair.jcfg, batch))


def test_loss_and_grads(pair):
    """The loss and the gradient of every parameter (the unembedding, the
    MLP of either form, MQA's single K / V head) against
    ``jax.value_and_grad``, under the model's ``"dots"`` remat."""
    assert pair.tcfg.remat_policy == "dots"
    batch = lm_batch(2, 32, 4)
    want_l, want_g = _grads(pair, batch)
    got_l, got_g = port_grads(TT.loss_fn, pair.tp, pair.tcfg, batch)
    tol = TOL[pair.dtype]
    scalar_close(got_l, want_l, tol["loss"])
    keys = [key for key, _ in key_paths(got_g)]
    assert len(keys) == n_port_leaves(pair.jp) and "['unembed']['w']" in keys
    for key, g in key_paths(got_g):
        want = port_key(want_g, key)
        assert g.shape == want.shape, key
        assert float(np.abs(want).max()) > 0, key
        close(g, want, dict(scale=tol["grad"]), key)


def test_train_step(pair):
    """One AdamW step: loss, grad_norm and lr against the JAX package's
    step on the same parameters and batch (``adamw_update`` on the
    gradients of :func:`test_loss_and_grads`, as its ``make_train_step``
    does at one microbatch); the step counts and every parameter moves."""
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=8)
    batch = lm_batch(2, 32, 4)
    loss, grads = _grads(pair, batch)
    update = pair.jax("adamw", lambda: jax.jit(
        lambda p, g: j_adamw.adamw_update(
            j_adamw.AdamWConfig(**opt), p, g, j_adamw.adamw_init(p),
            jnp.zeros((), jnp.int32))[2])(pair.jp, grads))
    want = {"loss": loss, **update}
    tstate = TT.train_state(TT.params_from_reference(
        jax.tree.map(np.asarray, pair.jp), device="cpu"))
    before = [t.clone() for t in tree_leaves(tstate["params"])]
    fns = t_registry.get_model_fns(pair.tcfg)
    tstep = fns.make_train_step(pair.tcfg, t_adamw.AdamWConfig(**opt), 1)
    tstate, got = tstep(tstate, batch)
    tol = TOL[pair.dtype]
    scalar_close(got["loss"], want["loss"], tol["loss"])
    scalar_close(got["grad_norm"], want["grad_norm"], tol["gnorm"],
                 relative=True)
    assert float(got["lr"]) == pytest.approx(float(want["lr"]), rel=1e-6)
    assert int(tstate["step"]) == 1
    assert all(not torch.equal(a, b) for a, b in
               zip(before, tree_leaves(tstate["params"])))


# ----------------------------------------------------- around the model ----


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_tokens_fp32(arch):
    """``BatchServer.generate`` on ragged prompts: the JAX package's greedy
    tokens (fp32)."""
    p = Pair(arch, "float32")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 512, size=n).astype(np.int32)
               for n in (5, 12, 9)]
    want = JServer(p.jcfg, p.jp, batch=4, max_seq=32).generate(prompts,
                                                              max_new=12)
    got = t_serve.BatchServer(p.tcfg, p.tp, batch=4, max_seq=32,
                              device="cpu").generate(prompts, max_new=12)
    assert [len(g) for g in got] == [len(w) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_gelu_mlp_is_the_tanh_form():
    """granite-34b's plain MLP, ``gelu(x @ w_in) @ w_out``, equals the JAX
    package's (``jax.nn.gelu``, whose default is the tanh approximation)
    in fp32 within 1e-6 of the largest output, on pre-activations spread
    over [-6, 6]; the exact (erf) GELU lies more than 10x that away, so
    the check tells the two forms apart."""
    cfg = t_smoke(G34).replace(compute_dtype="float32")
    p = TL.init_mlp(cfg, torch.Generator().manual_seed(3), "cpu")
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)) * 3.0
    want = np.asarray(JL.mlp_forward(
        {k: jnp.asarray(v.numpy()) for k, v in p.items()}, jnp.asarray(
            x.numpy()), j_smoke(G34).replace(compute_dtype="float32")))
    got = TL.mlp_forward(p, x, cfg)
    pre = x @ p["w_in"]
    assert float(pre.abs().max()) > 6 and set(p) == {"w_in", "w_out"}
    tol = 1e-6 * float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    erf = torch.nn.functional.gelu(pre) @ p["w_out"]
    assert float(np.abs(erf.numpy() - want).max()) > 10 * tol


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_counts(arch):
    """The port's full config equals the JAX package's field by field; its
    published parameter count, head layout and MLP; the smoke model's
    seeded init has the JAX package's element count, the analytic count
    plus the final norm and, with ``qk_norm``, each layer's two head
    norms (which ``param_count`` leaves out)."""
    full, jfull = t_get(arch), j_get(arch)
    for f in type(jfull).__dataclass_fields__:
        assert getattr(full, f) == getattr(jfull, f), f
    count, layers, d, h, kv, gated, qk = PUBLISHED[arch]
    assert full.param_count() == jfull.param_count() == count
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.d_head, full.mlp_gated, full.qk_norm) == (
        layers, d, h, kv, 128, gated, qk)
    assert not full.tie_embeddings and full.remat_policy == "dots"
    cfg = t_smoke(arch)
    p = TT.init_params(cfg, 0, device="cpu")
    jp = jax_params(_cfgs(arch, "float32")[0], arch)
    assert sum(t.numel() for t in tree_leaves(p)) == sum(
        x.size for x in jax.tree.leaves(jp)) == cfg.param_count() + \
        cfg.d_model + (2 * cfg.d_head * cfg.n_layers if cfg.qk_norm else 0)
    assert tuple(p["unembed"]["w"].shape) == (256, 512)


def test_registry_and_cache():
    """``get_model_fns`` gives the transformer's functions; ``init_cache``
    and ``batch_specs`` equal the JAX package's for each arch (MQA's one
    KV head)."""
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch, "bfloat16")
        fns = t_registry.get_model_fns(tcfg)
        assert (fns.prefill, fns.serve_step, fns.loss_fn) == (
            TT.prefill, TT.serve_step, TT.loss_fn)
        cache = fns.init_cache(tcfg, 2, 16, "cpu")
        jcache = JT.init_cache(jcfg, 2, 16)
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in cache.items()} == {
            k: (tuple(v.shape), str(v.dtype)) for k, v in jcache.items()}
        jshape, tshape = (JShape("train_4k", 64, 4, "train"),
                          ShapeSpec("train_4k", 64, 4, "train"))
        want = j_registry.synth_batch(jcfg, jshape, seed=4)
        got = t_registry.synth_batch(tcfg, tshape, seed=4)
        assert set(got) == set(want)
        for k in want:
            assert got[k].tobytes() == np.asarray(want[k]).tobytes(), k


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Both launchers on the three archs, in one subprocess without
    JAX."""
    cases = {}
    for arch in ARCHS:
        cases.update(launcher_cases(arch))
    return run_launchers(cases, tmp_path_factory.mktemp("launch"))


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_on_cpu_without_jax(arch, launched):
    """``launch.serve`` and ``launch.train`` take the arch's smoke model
    with ``--device cpu``; JAX unimportable."""
    rc, out = launched[f"serve {arch}"]
    assert rc == 0 and "[serve] wave 1: [" in out
    rc, out = launched[f"train {arch}"]
    assert rc == 0 and "[train] step     1 loss" in out


def test_flash_check_absolute_limit(chip_smoke):
    """``chip_smoke.flash_check``'s absolute bf16 limit is 2e-2, or one bf16
    ulp of |want| where that is larger (|want| >= 4: 0.03125): one ulp
    apart passes at 4.0 and fails at 2.0 by 2 ulps (0.03125); two ulps
    apart at 4.0 fail; the elementwise limit alone passes the first."""
    bf = torch.bfloat16

    def check(w, g, **kw):
        want = torch.full((1, 1, 1, 8), 0.5, dtype=bf)
        got = want.clone()
        want[..., 0], got[..., 0] = w, g
        return chip_smoke.flash_check(got, want, **kw)

    err, share = check(4.0, 4.03125)
    assert err == 0.03125 and share == 1.0
    assert check(2.0, 2.03125)[1] == pytest.approx(0.03125 / 2e-2)
    assert check(4.0, 4.0625)[1] > 1
    assert check(4.0, 4.03125, absolute=False)[1] < 1


def test_prefill_decode_matches_forward_mqa_bf16(chip_smoke):
    """The end-to-end check ``chip_smoke.py`` phase 21 makes at published
    widths, on granite-34b's smoke model (MQA, the GELU MLP), bf16:
    prefill + greedy decode against one ``forward`` over the same tokens
    within ``LM_E2E_*_TOL``; the planted fault (a decode given a zeroed
    K/V cache) exceeds both bounds."""
    cfg = t_smoke(G34)
    params = TT.init_params(cfg, 0, device="cpu")
    toks = torch.as_tensor(tokens(2, 24, 7)).long()
    good, bad = (chip_smoke.dense_e2e(cfg, params, toks, 8, 64, fault=f)
                 for f in (False, True))
    tol = {"bfloat16": {"max": chip_smoke.LM_E2E_MAX_TOL,
                        "mean": chip_smoke.LM_E2E_MEAN_TOL}}
    assert good["positions"] == 8 and good["rows"] == 2
    chip_smoke.check_e2e(G34, {"bfloat16": good}, tol)
    chip_smoke.check_e2e(G34, {"bfloat16": bad}, tol,
                         fault="a decode given a zeroed K/V cache")
    with pytest.raises(AssertionError, match="!= forward"):
        chip_smoke.check_e2e(G34, {"bfloat16": bad}, tol)

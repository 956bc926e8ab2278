"""The port's SSM and hybrid families (mamba2, zamba2: Mamba2 blocks, and
for zamba2 one shared attention + MLP block after every
``hybrid_attn_every``-th layer) equal the JAX package's, whole model.

Models: ``smoke_config`` of ``mamba2-780m`` (4 SSM layers), of
``zamba2-7b`` (4 layers, the shared block after layers 2 and 4: GQA 4/2,
dh 64) and the same zamba2 at 5 layers (``TAIL``: a last segment of one
layer with no shared block after it, as zamba2-7b's 81 = 13 x 6 + 3).
Parameters are the JAX package's own (``init_train_state``), handed over by
``params_from_reference``; tokens from a seeded numpy RNG.

Tolerances are the dense tests' (``tests/test_torch_lm.py``,
``tests/test_torch_train.py``): logits within 1e-4 (fp32) and 2**-5 of the
largest magnitude (bf16); caches (the fp32 SSM state, the conv tail, the
shared block's K/V) within 1e-5 / 2**-5; the loss within 1e-5 / 1e-3;
every gradient within 1e-5 / 2**-4 of its largest magnitude;
``grad_norm`` within 1e-5 / 2**-5 relative.

In bf16 a result passes that limit against the JAX package's bf16 result,
or else lies no further from the JAX package's fp32 result (same
parameters and inputs) than the larger of that limit and twice the JAX
package's own bf16 distance from it: the port's bf16 is then as accurate
as the reference's.  Both round to bf16 at other places, and in the SSM
some sums cancel: the gradients of ``A_log``, ``D``, ``dt_bias`` and the
conv biases add thousands of rounded terms, and the JAX package's own bf16
gradient lies up to 1.52 x 2**-4 of the largest magnitude from its fp32
one (the port's up to 1.35 x; the two bf16 gradients up to 1.60 x apart);
the loss over 62 tokens moves by up to 1.9e-3 between the JAX package's
bf16 and fp32 (and by 6e-4 between its eager and jitted bf16).  The fp32
comparisons hold the port to the JAX package everywhere.

The JAX package's results are jitted and computed once per model and
dtype (``tests/torch_lm_ref.py``); the launchers run in one subprocess.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import checkpoint as j_ckpt  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.launch.serve import BatchServer as JServer  # noqa: E402
from repro.models import registry as j_registry  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.common import ShapeSpec as JShape  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import get_config as t_get  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import registry as t_registry  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.common import ShapeSpec  # noqa: E402
from repro_torch.optim import adamw as t_adamw  # noqa: E402
from repro_torch.tree import key_paths, tree_leaves  # noqa: E402
from torch_lm_ref import (SRC, close as _close, jax_grads,  # noqa: E402
                          jit_call, launcher_cases, lm_batch as _batch,
                          one_torch_thread,
                          memo, port_grads, port_key as _port_key,
                          run_launchers, scalar_close as _scalar_close,
                          tokens as _tokens)

MAMBA, ZAMBA, TAIL = "mamba2-780m", "zamba2-7b", "zamba2-tail"
ARCHS = (MAMBA, ZAMBA, TAIL)
TOL = {"float32": dict(logits=dict(atol=1e-4), cache=dict(atol=1e-5),
                       loss=1e-5, grad=1e-5, gnorm=1e-5),
       "bfloat16": dict(logits=dict(scale=2 ** -5), cache=dict(scale=2 ** -5),
                        loss=1e-3, grad=2 ** -4, gnorm=2 ** -5)}


def _cfgs(arch, dtype, **kw):
    kw = {"compute_dtype": dtype, "cache_dtype": dtype, **kw}
    if arch == TAIL:
        kw["n_layers"] = 5
        arch = ZAMBA
    return j_smoke(arch).replace(**kw), t_smoke(arch).replace(**kw)


class Pair:
    """One model: both configs, the JAX parameters and the port's."""

    def __init__(self, arch, dtype):
        self.arch, self.dtype = arch, dtype
        self.jcfg, self.tcfg = _cfgs(arch, dtype)

        def init():
            state, _ = j_registry.get_model_fns(self.jcfg).init_train_state(
                self.jcfg, jax.random.key(0))
            return state["params"]
        # fp32 parameters in both dtypes, made once per arch
        self.jp = memo((arch, "params"), init)
        self.tp = TT.params_from_reference(
            jax.tree.map(np.asarray, self.jp), device="cpu")

    def jax(self, name, jcfg, fn):
        """``fn(jcfg)``, once per arch, dtype and name."""
        return memo((self.arch, jcfg.compute_dtype, name), lambda: fn(jcfg))

    def ref(self, name, fn):
        """``fn(jcfg)`` for this dtype and, in bf16, for fp32 too ->
        (result, fp32 result or None)."""
        got = self.jax(name, self.jcfg, fn)
        if self.dtype == "float32":
            return got, None
        return got, self.jax(name, _cfgs(self.arch, "float32")[0], fn)


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    return Pair(*request.param)


def _grow(jc, max_seq):
    """The JAX server's growth of a hybrid's shared K/V to max_seq."""
    out = dict(jc)
    for k in ("attn_k", "attn_v"):
        if k in out:
            pad = [(0, 0)] * out[k].ndim
            pad[2] = (0, max_seq - out[k].shape[2])
            out[k] = jnp.pad(out[k], pad)
    return out


# ----------------------------------------------------------- the model ----


def test_params_from_reference(pair):
    """Every JAX leaf arrives bit for bit, ``layers`` unstacked (counted by
    any leaf: an SSM block has no ``ln1``), a hybrid's ``shared_attn``
    whole."""
    cfg = pair.tcfg
    assert len(pair.tp["layers"]) == cfg.n_layers
    assert all(set(b) == {"norm", "ssm"} for b in pair.tp["layers"])
    n_stacked = len(jax.tree.leaves(pair.jp["layers"]))
    assert len(key_paths(pair.tp)) == (len(jax.tree.leaves(pair.jp))
                                       + (cfg.n_layers - 1) * n_stacked)
    for key, t in key_paths(pair.tp):
        np.testing.assert_array_equal(t.numpy(), _port_key(pair.jp, key),
                                      err_msg=key)
    hybrid = cfg.family == "hybrid"
    assert ("shared_attn" in pair.tp) == hybrid
    if hybrid:
        assert set(pair.tp["shared_attn"]) == {"ln1", "ln2", "attn", "mlp"}


def test_forward(pair):
    toks = _tokens(2, 64, 1)
    (want, jaux), w32 = pair.ref("forward", lambda c: jit_call(
        JT.forward, c, pair.jp, jnp.asarray(toks)))
    got, taux = TT.forward(pair.tp, pair.tcfg, torch.as_tensor(toks).long())
    assert tuple(got.shape) == (2, 64, pair.tcfg.vocab_padded)
    assert got.dtype == pair.tcfg.cdtype() and bool(torch.isfinite(got).all())
    _close(got, want, TOL[pair.dtype]["logits"],
           want32=w32 and w32[0])
    assert float(taux) == float(jaux) == 0.0


def test_prefill_and_cache(pair):
    """Prefill over 2 chunks of 32 and over one shorter chunk: logits, the
    state caches and a hybrid's shared K/V (one row per application)."""
    tol = TOL[pair.dtype]
    for B, S, seed in ((3, 64, 2), (2, 20, 3)):
        toks = _tokens(B, S, seed)
        (want, jc), w32 = pair.ref(f"prefill{S}", lambda c: jit_call(
            JT.prefill, c, pair.jp, jnp.asarray(toks)))
        got, tc = TT.prefill(pair.tp, pair.tcfg, torch.as_tensor(toks).long())
        assert got.dtype == torch.float32
        _close(got, want, tol["logits"], want32=w32 and w32[0])
        assert set(tc) == set(jc)
        for key in jc:
            assert tuple(tc[key].shape) == tuple(jc[key].shape), key
            assert tc[key].dtype == getattr(torch, str(jc[key].dtype)), key
            _close(tc[key], jc[key], tol["cache"], key,
                   want32=w32 and w32[1][key])
    assert tc["ssm"].dtype == torch.float32
    napp = TT.n_shared_apps(pair.tcfg)
    if pair.tcfg.family == "hybrid":
        assert tc["attn_k"].shape[0] == napp == JT.n_shared_apps(pair.jcfg)


def test_serve_step(pair):
    """Prefill 20 tokens, a hybrid's K/V grown to 32 rows, then two decode
    steps: logits and every cache."""
    toks = _tokens(2, 20, 3)

    def jax_steps(c):
        # the prefill test's (same tokens)
        _, jc = pair.jax("prefill20", c, lambda c: jit_call(
            JT.prefill, c, pair.jp, jnp.asarray(toks)))
        jc, out = _grow(jc, 32), []
        step_fn = jax.jit(lambda p, cache, tok, n: JT.serve_step(
            p, c, cache, tok, n))
        for step, tok in enumerate(([5, 300], [17, 2])):
            logits, jc = step_fn(pair.jp, jc, jnp.asarray(tok, jnp.int32),
                                 jnp.int32(20 + step))
            out.append((logits, jc))
        return out

    want, w32 = pair.ref("serve_step", jax_steps)
    _, pc = TT.prefill(pair.tp, pair.tcfg, torch.as_tensor(toks).long())
    tc = TT.init_cache(pair.tcfg, 2, 32, device="cpu")
    # the prefill's caches are the decode cache's but 20 rows of K/V long
    assert {k: (tuple(v.shape[:2]) + (20 if k.startswith("attn") else
                                      v.shape[2],) + tuple(v.shape[3:]),
                v.dtype) for k, v in tc.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in pc.items()}
    t_serve.BatchServer._splice(tc, pc)
    tol = TOL[pair.dtype]
    for step, tok in enumerate(([5, 300], [17, 2])):
        got, tc = TT.serve_step(pair.tp, pair.tcfg, tc, torch.tensor(tok),
                                20 + step)
        (jl, jc), ref32 = want[step], w32 and w32[step]
        assert tuple(got.shape) == (2, pair.tcfg.vocab_padded)
        _close(got, jl, tol["logits"], f"step {step}",
               want32=ref32 and ref32[0])
        for key in tc:
            _close(tc[key], jc[key], tol["cache"], key,
                   want32=ref32 and ref32[1][key])


def test_loss_and_grads(pair):
    """The loss and the gradient of every parameter (every SSM leaf, the
    shared block's, norms, embeddings) against ``jax.value_and_grad``,
    under the models' ``"dots"`` remat."""
    assert pair.tcfg.remat_policy == "dots"
    batch = _batch(2, 64, 4)
    (want_l, want_g), w32 = pair.ref("grads", lambda c: jax_grads(
        JT.loss_fn, pair.jp, c, batch))
    got_l, got_g = port_grads(TT.loss_fn, pair.tp, pair.tcfg, batch)
    tol = TOL[pair.dtype]
    _scalar_close(got_l, want_l, tol["loss"], w32 and w32[0])
    names = set()
    for key, g in key_paths(got_g):
        want = _port_key(want_g, key)
        assert g.shape == want.shape, key
        assert float(np.abs(want).max()) > 0, key
        _close(g, want, dict(scale=tol["grad"]), key,
               want32=w32 and _port_key(w32[1], key))
        names.add(key.rsplit("[", 1)[1].strip("']"))
    assert {"A_log", "D", "dt_bias", "w_x", "w_B", "w_C", "conv_w_x",
            "conv_b_bc", "w_out", "norm_w"} <= names
    if pair.tcfg.family == "hybrid":
        assert {"wq", "wk", "wv", "wo", "w1", "w2", "w3"} <= names


def test_train_step(pair):
    """One AdamW step: loss, grad_norm and lr against the JAX package's
    step on the same parameters and batch (its ``make_train_step`` at one
    microbatch is ``value_and_grad`` of the loss, then ``adamw_update``:
    here on the gradients of :func:`test_loss_and_grads`); the step counts
    and every parameter moves."""
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=8)
    batch = _batch(2, 64, 4)

    def jax_step(c):
        loss, grads = pair.jax("grads", c, lambda c: jax_grads(
            JT.loss_fn, pair.jp, c, batch))
        update = jax.jit(lambda p, g: j_adamw.adamw_update(
            j_adamw.AdamWConfig(**opt), p, g, j_adamw.adamw_init(p),
            jnp.zeros((), jnp.int32))[2])
        return {"loss": loss, **update(pair.jp, grads)}

    want, w32 = pair.ref("train_step", jax_step)
    tstate = TT.train_state(TT.params_from_reference(
        jax.tree.map(np.asarray, pair.jp), device="cpu"))
    before = [t.clone() for t in tree_leaves(tstate["params"])]
    tstep = TT.make_train_step(pair.tcfg, t_adamw.AdamWConfig(**opt), 1)
    tstate, got = tstep(tstate, batch)
    tol = TOL[pair.dtype]
    _scalar_close(got["loss"], want["loss"], tol["loss"],
                  w32 and w32["loss"])
    _scalar_close(got["grad_norm"], want["grad_norm"], tol["gnorm"],
                  w32 and w32["grad_norm"], relative=True)
    assert float(got["lr"]) == pytest.approx(float(want["lr"]), rel=1e-6)
    assert int(tstate["step"]) == 1
    assert all(not torch.equal(a, b) for a, b in
               zip(before, tree_leaves(tstate["params"])))


# ----------------------------------------------------- around the model ----


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_tokens_fp32(arch):
    """``BatchServer.generate`` on ragged prompts (padded at the end; the
    pads pass through the SSM state, as in the JAX package): the JAX
    package's greedy tokens (fp32)."""
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


@pytest.mark.parametrize("arch", ARCHS)
def test_registry_batches_and_cache(arch):
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    fns = t_registry.get_model_fns(tcfg)
    assert fns.prefill is TT.prefill and fns.init_cache is TT.init_cache
    cache = fns.init_cache(tcfg, 2, 16, "cpu")
    jcache = JT.init_cache(jcfg, 2, 16)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in cache.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in jcache.items()}
    assert not any(bool(v.any()) for v in cache.values())
    for name in ("train_4k", "prefill_32k"):
        kind = name.split("_")[0]
        jshape, tshape = JShape(name, 64, 4, kind), ShapeSpec(name, 64, 4,
                                                              kind)
        want = j_registry.batch_specs(jcfg, jshape)
        got = t_registry.batch_specs(tcfg, tshape)
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: tuple(v.shape) for k, v in want.items()}
        want = j_registry.synth_batch(jcfg, jshape, seed=4)
        got = t_registry.synth_batch(tcfg, tshape, seed=4)
        assert set(got) == set(want)
        for k in want:
            assert got[k].tobytes() == np.asarray(want[k]).tobytes()


def test_init_params_layout():
    """The port's seeded init: SSM blocks of the split layout, zamba2's one
    shared block at d_ff; the published parameter counts of both models
    (and the port's leaves add up to the JAX package's count at smoke
    width)."""
    for arch in (MAMBA, ZAMBA):
        cfg = t_smoke(arch)
        p = TT.init_params(cfg, 0, device="cpu")
        assert len(p["layers"]) == cfg.n_layers
        assert set(p["layers"][0]["ssm"]) >= {"w_x", "w_B", "w_C",
                                              "conv_w_x", "conv_w_bc"}
        assert ("shared_attn" in p) == (arch == ZAMBA)
        assert sum(t.numel() for t in tree_leaves(p)) == sum(
            x.size for x in jax.tree.leaves(Pair(arch, "float32").jp))
    zp = TT.init_params(t_smoke(ZAMBA), 0, device="cpu")
    assert tuple(zp["shared_attn"]["mlp"]["w1"].shape) == (256, 512)
    assert t_get(MAMBA).param_count() == 780221184
    assert t_get(ZAMBA).param_count() == 6750536272
    assert TT.n_shared_apps(t_get(ZAMBA)) == 13
    assert TT._hybrid_segments(t_get(ZAMBA))[-1] == (78, 81, False)


def test_checkpoint_roundtrip_both_ways(tmp_path):
    """The zamba2 smoke model's training state (a ``shared_attn`` beside
    the layers): a port checkpoint restores through ``repro.checkpoint``
    into a JAX tree of the same structure, and a JAX checkpoint into the
    port's template, leaves equal."""
    _, tcfg = _cfgs(ZAMBA, "float32")
    state = TT.train_state(TT.init_params(tcfg, 2, device="cpu"))
    state, _ = TT.make_train_step(tcfg, t_adamw.AdamWConfig(), 1)(
        state, _batch(2, 32, 1))
    assert any("['shared_attn']" in k for k, _ in key_paths(state))
    ckpt.save(str(tmp_path / "port"), 1, state)
    template = jax.tree.map(lambda t: jnp.zeros(t.shape, t.numpy().dtype),
                            state, is_leaf=lambda x: isinstance(
                                x, torch.Tensor))
    got, step = j_ckpt.restore(str(tmp_path / "port"), template)
    assert step == 1 and len(jax.tree.leaves(got)) == len(tree_leaves(state))
    for (k, a), b in zip(key_paths(state), jax.tree.leaves(got)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=k)
    jstate = jax.tree.map(lambda t: jnp.asarray(t.numpy() + 1), state,
                          is_leaf=lambda x: isinstance(x, torch.Tensor))
    j_ckpt.save(str(tmp_path / "jax"), 5, jstate)
    got, step = ckpt.restore(str(tmp_path / "jax"), state)
    assert step == 5
    for (k, a), b in zip(key_paths(got), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=k)


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Both launchers on both archs, in one subprocess without JAX."""
    return run_launchers({**launcher_cases(MAMBA), **launcher_cases(ZAMBA)},
                         tmp_path_factory.mktemp("launch"))


@pytest.mark.parametrize("arch", [MAMBA, ZAMBA])
def test_launchers_on_cpu_without_jax(arch, launched):
    """``launch.serve`` and ``launch.train`` take the SSM and hybrid archs
    with ``--device cpu``; JAX unimportable."""
    rc, out = launched[f"serve {arch}"]
    assert rc == 0 and "[serve] wave 1: [" in out
    rc, out = launched[f"train {arch}"]
    assert rc == 0 and "[train] step     1 loss" in out


# The smoke models' bounds for chip_smoke's check, between what a sound
# decode gives here (bf16 at most 0.0166 / 0.00214, fp32 1.2e-6 / 2.0e-7)
# and what the planted fault gives (bf16 and fp32 at least 0.322 / 0.0429),
# about 4x from each.
SMOKE_E2E_TOL = {"bfloat16": {"max": 0.08, "mean": 0.01},
                 "float32": {"max": 1e-3, "mean": 1e-4}}


@pytest.mark.parametrize("arch", [MAMBA, TAIL])
def test_prefill_decode_matches_forward_bf16(arch, monkeypatch):
    """The end-to-end check ``chip_smoke.py`` makes at published widths, on
    the smoke model, in bf16 and in fp32: a wave served, then one
    ``forward`` over its prompts, decoded tokens and filler up to a chunk
    multiple (the SSD is causal, so the filler moves no compared position)
    holds the prefill and decode logits within the bounds; a decode that
    forgets the SSM state carried from the prefill exceeds them all."""
    monkeypatch.syspath_prepend(os.path.dirname(SRC))
    import chip_smoke

    prompts = [_tokens(1, 32, 7)[0], _tokens(1, 32, 8)[0]]

    def run(drop_state):
        out = {}
        for dtype in SMOKE_E2E_TOL:
            _, cfg = _cfgs(arch, dtype)
            params = TT.init_params(cfg, 0, device="cpu")
            out[dtype] = chip_smoke.ssm_e2e(cfg, params, prompts, new=8,
                                            device="cpu",
                                            drop_state=drop_state)
        return out

    good, bad = run(False), run(True)
    assert good["bfloat16"]["positions"] == 9
    assert good["bfloat16"]["padded_to"] == 64
    chip_smoke.check_ssm_e2e(arch, good, SMOKE_E2E_TOL)
    chip_smoke.check_ssm_e2e(arch, bad, SMOKE_E2E_TOL, fault=True)
    with pytest.raises(AssertionError, match="prefill \\+ decode"):
        chip_smoke.check_ssm_e2e(arch, bad, SMOKE_E2E_TOL)
    with pytest.raises(AssertionError, match="without the SSM state"):
        chip_smoke.check_ssm_e2e(arch, good, SMOKE_E2E_TOL, fault=True)

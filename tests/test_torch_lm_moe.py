"""The port's MoE family (phi3.5-moe, deepseek-v2-lite: MoE layers, MLA,
leading dense layers, shared experts) equals the JAX package's, whole
model: the torch twins of ``tests/test_models_smoke.py``'s forward, decode
and train-step cases, held against the JAX package.

Models: ``smoke_config`` of ``phi3.5-moe-42b-a6.6b`` (GQA 4/2, 4 MoE
layers), of ``deepseek-v2-lite-16b`` (MLA, a dense head layer, 3 MoE
layers with a shared expert) and a GQA MoE model with a head layer and a
shared expert (``GQA_HEAD``), so head layers are tested apart from MLA.
Parameters are the JAX package's own (``init_train_state``), handed over
by ``params_from_reference``; tokens from a seeded numpy RNG.

Routes.  Top-k routing is a discontinuous function of the router logits.
In fp32 the two packages differ only in the order of sums and every route
must be equal.  In bf16 XLA and PyTorch round at other places, so a token
whose K-th and (K+1)-th experts nearly tie may take the other one, and
the whole-model outputs would then differ by far more than rounding.  So
in bf16 the JAX package's routes (recorded in program order by a
``jax.debug.callback`` around its ``lax.top_k``) are given to the port's
layers (``moe.top_k``, matched to a layer by its router's storage).  The
port's own router probabilities must then lie within ``BF16_TIE``
(relative; measured up to 0.060) of the JAX package's, so its own choice
can differ only on such near ties, and on at most ``BF16_ROUTES`` of the
tokens (measured up to 2.3%).

Tolerances are the dense tests' (``tests/test_torch_lm.py``,
``tests/test_torch_train.py``): logits within 1e-4 (fp32) and 2**-5 of
the largest magnitude (bf16); caches within 1e-5 / 2**-5; loss within
1e-5 / 1e-3; every gradient within 1e-5 / 2**-4 of its largest magnitude;
``grad_norm`` within 1e-5 / 2**-5 relative; the summed aux loss within
1e-5 / 1e-2.

The JAX package's results are jitted and computed once per model and
dtype (``tests/torch_lm_ref.py``): the loss and gradients serve both the
gradient test and the AdamW step's; the launchers run in one subprocess.
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
from repro.models import moe as JM  # noqa: E402
from repro.models import registry as j_registry  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.common import ShapeSpec as JShape  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import registry as t_registry  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.common import ShapeSpec  # noqa: E402
from repro_torch.optim import adamw as t_adamw  # noqa: E402
from repro_torch.tree import key_paths, tree_leaves  # noqa: E402
from torch_lm_ref import (SRC, close as _close, jax_grads,  # noqa: E402
                          jax_params, jit_call, launcher_cases,
                          one_torch_thread,
                          lm_batch as _batch, memo, np_ as _np, port_grads,
                          port_key as _port_key, run_launchers,
                          tokens as _tokens)

PHI, DSV2 = "phi3.5-moe-42b-a6.6b", "deepseek-v2-lite-16b"
GQA_HEAD = "gqa-head"
ARCHS = (PHI, DSV2, GQA_HEAD)
TOL = {"float32": dict(logits=dict(atol=1e-4), cache=dict(atol=1e-5),
                       loss=1e-5, grad=1e-5, gnorm=1e-5, aux=1e-5),
       "bfloat16": dict(logits=dict(scale=2 ** -5), cache=dict(scale=2 ** -5),
                        loss=1e-3, grad=2 ** -4, gnorm=2 ** -5, aux=1e-2)}
BF16_TIE = 2 ** -3
BF16_ROUTES = 0.05


def _cfgs(arch, dtype, **kw):
    kw = {"compute_dtype": dtype, "cache_dtype": dtype, **kw}
    if arch == GQA_HEAD:
        kw.update(first_k_dense=1, dense_layer_ff=256, n_shared_experts=1)
        arch = PHI
    return j_smoke(arch).replace(**kw), t_smoke(arch).replace(**kw)


class Pair:
    """One model: both configs, the JAX parameters and the port's."""

    def __init__(self, arch, dtype, **kw):
        self.arch, self.dtype = arch, dtype
        self.jcfg, self.tcfg = _cfgs(arch, dtype, **kw)
        self.jp = jax_params(self.jcfg, arch)
        self.tp = TT.params_from_reference(
            jax.tree.map(np.asarray, self.jp), device="cpu")
        self.n_moe = self.jcfg.n_layers - (self.jcfg.first_k_dense
                                           if self.jcfg.is_moe else 0)


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    return Pair(*request.param)


class _LaxRecorder:
    """Stands in for ``jax.lax`` in the JAX package's moe module: its
    ``top_k``, with each call's probabilities and routes recorded in
    program order."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return getattr(jax.lax, name)

    def top_k(self, probs, k):
        vals, idx = jax.lax.top_k(probs, k)
        jax.debug.callback(lambda p, i: self.calls.append(
            (np.asarray(p), np.asarray(i))), probs, idx, ordered=True)
        return vals, idx


@pytest.fixture
def jax_routes(monkeypatch):
    """``run(fn, *args)`` -> (fn's result, [(probs, routes)] of its MoE
    calls in program order); ``fn`` is traced afresh under the recorder
    (``jit_call`` and ``jax_grads`` jit a new function each call)."""
    rec = _LaxRecorder()
    monkeypatch.setattr(JM, "lax", rec)

    def run(fn, *args):
        rec.calls.clear()
        out = fn(*args)
        jax.effects_barrier()
        return out, list(rec.calls)
    return run


def _grads_with_routes(pair, jax_routes, batch):
    """The JAX package's loss and gradients on ``batch`` and the routes of
    its forward, once per arch and dtype (the gradient test's and the
    AdamW step's)."""
    def run():
        out, calls = jax_routes(jax_grads, JT.loss_fn, pair.jp, pair.jcfg,
                                batch)
        return out, calls[:pair.n_moe]   # the forward's; then the recompute
    return memo((pair.arch, pair.dtype, "grads"), run)


class _Routes:
    """Gives each of the port's MoE layers the JAX package's routes
    (``moe.top_k`` patched; a layer is known by its router's storage, so
    the routes hold through ``detach`` and remat recomputes) and records
    the port's own router probabilities and choice."""

    def __init__(self, monkeypatch, tparams):
        self.moe = [b["moe"]["router"] for b in
                    tparams.get("head_layers", []) + tparams["layers"]
                    if "moe" in b]
        self.by_ptr, self.current, self.seen = {}, None, []
        fwd, top = TM.moe_forward, TM.top_k

        def moe_forward(p, x, cfg, stats=None):
            self.current = self.by_ptr[p["router"].data_ptr()]
            return fwd(p, x, cfg, stats)

        def top_k(probs, k):
            own = top(probs, k)[1]
            idx = torch.tensor(self.current[1]).long()
            self.seen.append((self.current[0], probs.detach(), own, idx))
            return probs.gather(-1, idx), idx

        monkeypatch.setattr(TM, "moe_forward", moe_forward)
        monkeypatch.setattr(TM, "top_k", top_k)

    def give(self, calls):
        """The JAX calls of one pass (one per MoE layer, in order)."""
        assert len(calls) == len(self.moe)
        self.by_ptr = {r.data_ptr(): c for r, c in zip(self.moe, calls)}

    def check(self, dtype):
        """fp32: the port's own routes equal the JAX package's.  bf16: its
        router probabilities lie within BF16_TIE (relative) of the JAX
        package's, so its own choice can differ only where the JAX
        package's K-th and (K+1)-th probabilities are that close (a swap
        needs a relative gap of at most 2 x BF16_TIE); at most
        BF16_ROUTES of the tokens differ."""
        n = differ = 0
        worst = 0.0
        for jprobs, probs, own, idx in self.seen:
            own, idx = np.sort(own.numpy(), 1), np.sort(idx.numpy(), 1)
            bad = np.any(own != idx, axis=1)
            assert dtype != "float32" or not bad.any(), np.flatnonzero(bad)
            n, differ = n + len(own), differ + int(bad.sum())
            worst = max(worst, float(np.max(np.abs(probs.numpy() - jprobs)
                                            / jprobs)))
        assert n and worst <= BF16_TIE and differ <= BF16_ROUTES * n, (
            differ, n, worst)


# ----------------------------------------------------------- the model ----


def test_params_from_reference(pair):
    """Every JAX leaf arrives, ``layers`` unstacked and ``head_layers`` as
    its list, bit for bit; head layers hold an MLP of dense_layer_ff."""
    cfg = pair.tcfg
    n_head = len(pair.tp.get("head_layers", []))
    assert n_head == (cfg.first_k_dense if cfg.is_moe else 0)
    assert len(pair.tp["layers"]) == cfg.n_layers - n_head
    for key, t in key_paths(pair.tp):
        np.testing.assert_array_equal(t.numpy(), _port_key(pair.jp, key),
                                      err_msg=key)
    for blk in pair.tp.get("head_layers", []):
        assert "moe" not in blk
        assert tuple(blk["mlp"]["w1"].shape) == (cfg.d_model,
                                                 cfg.dense_layer_ff)
    assert all("moe" in b and "mlp" not in b for b in pair.tp["layers"])
    mla = cfg.attn_kind == "mla"
    assert ("w_dkv" in pair.tp["layers"][0]["attn"]) == mla


def test_forward(pair, jax_routes, monkeypatch):
    """Forward logits and the summed aux loss (the twin of
    ``test_forward_shapes_no_nan``)."""
    toks = _tokens(2, 40, 1)
    (want, jaux), calls = jax_routes(jit_call, JT.forward, pair.jcfg,
                                     pair.jp, jnp.asarray(toks))
    assert len(calls) == pair.n_moe
    routes = _Routes(monkeypatch, pair.tp)
    routes.give(calls)
    got, taux = TT.forward(pair.tp, pair.tcfg, torch.as_tensor(toks).long())
    assert tuple(got.shape) == (2, 40, pair.tcfg.vocab_padded)
    assert got.dtype == pair.tcfg.cdtype() and bool(torch.isfinite(got).all())
    tol = TOL[pair.dtype]
    _close(got, want, tol["logits"])
    assert abs(float(taux) - float(jaux)) <= tol["aux"]
    routes.check(pair.dtype)


def test_prefill_and_cache(pair, jax_routes, monkeypatch):
    toks = _tokens(3, 37, 2)
    (want, jc), calls = jax_routes(jit_call, JT.prefill, pair.jcfg,
                                   pair.jp, jnp.asarray(toks))
    routes = _Routes(monkeypatch, pair.tp)
    routes.give(calls)
    got, tc = TT.prefill(pair.tp, pair.tcfg, torch.as_tensor(toks).long())
    assert got.dtype == torch.float32
    tol = TOL[pair.dtype]
    _close(got, want, tol["logits"])
    names = ("ckv", "kr") if pair.tcfg.attn_kind == "mla" else ("k", "v")
    assert set(tc) == set(jc) == set(names)
    for key in names:
        assert tuple(tc[key].shape) == tuple(jc[key].shape)
        assert str(tc[key].dtype).endswith(pair.dtype)
        _close(tc[key], jc[key], tol["cache"], key)
    routes.check(pair.dtype)


def test_serve_step(pair, jax_routes, monkeypatch):
    """Prefill 20 tokens into a 32-row cache, then two decode steps: logits
    and cache (the twin of ``test_decode_step``)."""
    toks = _tokens(2, 20, 3)
    (_, jpc), calls = jax_routes(jit_call, JT.prefill, pair.jcfg,
                                 pair.jp, jnp.asarray(toks))
    jc = JT.init_cache(pair.jcfg, 2, 32)
    jc = {k: jax.lax.dynamic_update_slice_in_dim(v, jpc[k], 0, axis=2)
          for k, v in jc.items()}
    routes = _Routes(monkeypatch, pair.tp)
    routes.give(calls)
    _, tpc = TT.prefill(pair.tp, pair.tcfg, torch.as_tensor(toks).long())
    tc = TT.init_cache(pair.tcfg, 2, 32, device="cpu")
    assert set(tc) == set(jc)
    for key in tc:
        assert tuple(tc[key].shape) == tuple(jc[key].shape)
        tc[key][:, :, :20] = tpc[key]
    tol = TOL[pair.dtype]
    for step, tok in enumerate(([5, 300], [17, 2])):
        (want, jc), calls = jax_routes(
            jit_call, JT.serve_step, pair.jcfg, pair.jp, jc,
            jnp.asarray(tok, jnp.int32), jnp.int32(20 + step))
        routes.give(calls)
        got, tc = TT.serve_step(pair.tp, pair.tcfg, tc, torch.tensor(tok),
                                20 + step)
        assert tuple(got.shape) == (2, pair.tcfg.vocab_padded)
        _close(got, want, tol["logits"], f"step {step}")
        for key in tc:
            _close(tc[key], jc[key], tol["cache"], key)
    routes.check(pair.dtype)


def test_loss_and_grads(pair, jax_routes, monkeypatch):
    """The loss with its aux term and the gradient of every parameter
    (router, experts, shared expert, MLA or GQA, head layers, norms,
    embeddings) against ``jax.value_and_grad``, under the model's
    ``"dots"`` remat."""
    batch = _batch(2, 32, 4)
    (want_l, want_g), calls = _grads_with_routes(pair, jax_routes, batch)
    routes = _Routes(monkeypatch, pair.tp)
    routes.give(calls)
    got_l, got_g = port_grads(TT.loss_fn, pair.tp, pair.tcfg, batch)
    tol = TOL[pair.dtype]
    assert abs(float(got_l) - float(want_l)) <= tol["loss"]
    names = set()
    for key, g in key_paths(got_g):
        want = _port_key(want_g, key)
        assert g.shape == want.shape, key
        assert float(np.abs(want).max()) > 0, key
        np.testing.assert_allclose(_np(g), want, rtol=0,
                                   atol=tol["grad"] * np.abs(want).max(),
                                   err_msg=key)
        names.add(key.rsplit("[", 1)[1].strip("']"))
    assert {"router", "w1", "w2", "w3", "wq", "wo"} <= names
    routes.check(pair.dtype)
    # the aux term is in the loss
    aux_free = pair.tcfg.replace(router_aux_coef=0.0)
    with torch.no_grad():
        ce = TT.loss_fn(pair.tp, aux_free, {k: torch.as_tensor(v)
                                            for k, v in batch.items()})
        _, aux = TT.forward(pair.tp, pair.tcfg, torch.as_tensor(
            batch["tokens"]).long())
    coef = pair.tcfg.router_aux_coef / pair.tcfg.n_layers
    assert float(got_l - ce) == pytest.approx(coef * float(aux), rel=1e-3)


def test_train_step(pair, jax_routes, monkeypatch):
    """One AdamW step (the twin of ``test_train_step``): loss, grad_norm
    and lr against the JAX package's step on the same parameters (its
    ``make_train_step`` at one microbatch is ``value_and_grad`` of the
    loss, then ``adamw_update``: here on the gradients of
    :func:`test_loss_and_grads`); the step counts and the parameters
    move."""
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=8)
    batch = _batch(2, 32, 4)
    (loss, grads), calls = _grads_with_routes(pair, jax_routes, batch)
    update = jax.jit(lambda p, g: j_adamw.adamw_update(
        j_adamw.AdamWConfig(**opt), p, g, j_adamw.adamw_init(p),
        jnp.zeros((), jnp.int32))[2])
    want = {"loss": loss, **update(pair.jp, grads)}
    tstate = TT.train_state(TT.params_from_reference(
        jax.tree.map(np.asarray, pair.jp), device="cpu"))
    routes = _Routes(monkeypatch, tstate["params"])
    routes.give(calls)
    before = [t.clone() for t in tree_leaves(tstate["params"])]
    tstep = TT.make_train_step(pair.tcfg, t_adamw.AdamWConfig(**opt), 1)
    tstate, got = tstep(tstate, batch)
    tol = TOL[pair.dtype]
    assert abs(float(got["loss"]) - float(want["loss"])) <= tol["loss"]
    assert abs(float(got["grad_norm"]) / float(want["grad_norm"]) - 1) \
        <= tol["gnorm"]
    assert float(got["lr"]) == pytest.approx(float(want["lr"]), rel=1e-6)
    assert int(tstate["step"]) == 1
    moved = [not torch.equal(a, b) for a, b in
             zip(before, tree_leaves(tstate["params"]))]
    assert all(moved)
    routes.check(pair.dtype)


# ----------------------------------------------------- around the model ----


@pytest.mark.parametrize("arch", [PHI, DSV2])
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


@pytest.mark.parametrize("arch", [PHI, DSV2])
def test_registry_and_batches(arch):
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    fns = t_registry.get_model_fns(tcfg)
    assert fns.loss_fn is TT.loss_fn and fns.init_cache is TT.init_cache
    cache = fns.init_cache(tcfg, 2, 16, "cpu")
    jcache = JT.init_cache(jcfg, 2, 16)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: tuple(v.shape) for k, v in jcache.items()}
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
    """The port's seeded init: deepseek's first layer dense at
    dense_layer_ff, the rest MoE with a shared expert; the published
    parameter counts."""
    cfg = t_smoke(DSV2)
    p = TT.init_params(cfg, 0, device="cpu")
    assert len(p["head_layers"]) == 1 and len(p["layers"]) == 3
    assert tuple(p["head_layers"][0]["mlp"]["w2"].shape) == (
        cfg.dense_layer_ff, cfg.d_model)
    assert set(p["layers"][0]["moe"]) == {"router", "w1", "w2", "w3",
                                          "shared"}
    assert "head_layers" not in TT.init_params(t_smoke(PHI), 0, device="cpu")


def test_checkpoint_roundtrip_both_ways(tmp_path):
    """The deepseek smoke model's training state (``head_layers`` a list):
    a port checkpoint restores through ``repro.checkpoint`` into a JAX tree
    of the same structure, and a JAX checkpoint into the port's template,
    leaves equal."""
    _, tcfg = _cfgs(DSV2, "float32")
    state = TT.train_state(TT.init_params(tcfg, 2, device="cpu"))
    state, _ = TT.make_train_step(tcfg, t_adamw.AdamWConfig(), 1)(
        state, _batch(2, 16, 1))
    assert any("['head_layers'][0]" in k for k, _ in key_paths(state))
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
    return run_launchers({**launcher_cases(PHI), **launcher_cases(DSV2)},
                         tmp_path_factory.mktemp("launch"))


@pytest.mark.parametrize("arch", [PHI, DSV2])
def test_launchers_on_cpu_without_jax(arch, launched):
    """``launch.serve`` and ``launch.train`` take the MoE archs with
    ``--device cpu``; JAX unimportable."""
    rc, out = launched[f"serve {arch}"]
    assert rc == 0 and "[serve] wave 1: [" in out
    rc, out = launched[f"train {arch}"]
    assert rc == 0 and "[train] step     1 loss" in out


@pytest.mark.parametrize("arch", [PHI, DSV2])
def test_prefill_decode_matches_forward_bf16(arch, monkeypatch):
    """The end-to-end check ``chip_smoke.py`` makes at published widths,
    on the smoke model: a wave served at a capacity no slot can exceed,
    its routes recorded; one ``forward`` over the same tokens given those
    routes (and its own choice differing only on near ties) has the
    prefill and decode logits within the bf16 tolerance; a forward on
    routes shifted by one expert fails it."""
    monkeypatch.syspath_prepend(os.path.dirname(SRC))
    import chip_smoke

    cfg = t_smoke(arch)
    cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)
    params = TT.init_params(cfg, 0, device="cpu")
    prompts = [_tokens(1, 24, 7)[0], _tokens(1, 24, 8)[0]]
    check = chip_smoke.moe_e2e(cfg, params, prompts, new=8, device="cpu")
    chip_smoke.check_moe_e2e(arch, check)
    assert check["dropped"] == 0 and check["positions"] == 9
    shifted = chip_smoke.moe_e2e(cfg, params, prompts, new=8, device="cpu",
                                 shift=1)
    assert shifted["max"] > chip_smoke.LM_E2E_MAX_TOL
    assert shifted["mean"] > chip_smoke.LM_E2E_MEAN_TOL

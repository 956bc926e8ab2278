"""The port's training path equals the JAX package's.

Model: ``smoke_config("qwen3-0.6b")`` reduced as in
``tests/test_checkpoint.py`` (2 layers, d_model 64, 2 query heads over 1 KV
head, dh 32, d_ff 128, vocab 128), the JAX package's own parameters handed
to the port through ``params_from_reference``; tokens from a seeded numpy
RNG or the shared token stream.  The JAX reference runs on CPU JAX.

Tolerances (measured on this reduced model, four seeds):
- fp32 (``compute_dtype = "float32"``): the two differ only in the order of
  sums.  Loss within 1e-5 (measured 4.8e-7); every gradient within 1e-5 of
  its largest magnitude (measured 3.1e-6); ``grad_norm`` within 1e-5
  relative; per-step losses of a 3-step ``train`` within 5e-5 (measured
  6.2e-6: AdamW's first steps move each weight by about ``lr`` whatever the
  gradient's size, so a rounding of a near-zero gradient moves a weight by
  up to 2 lr).
- bf16 (the configs' default): the frameworks round at other places (the
  JAX ``_sdpa`` takes bf16 scores and weights, the flash forward fp32
  scores; XLA and PyTorch round elementwise chains differently).  Loss
  within 1e-3 (measured 1.6e-4), the LM tolerance of
  ``tests/test_torch_lm.py`` being 2**-5 of the logits' largest magnitude;
  every gradient within 2**-4 of its largest magnitude (measured up to
  0.040, on ``q_norm``, a sum over every position and head of bf16
  products two layers deep); ``grad_norm`` within 2**-5 relative; per-step
  losses of a 3-step ``train`` within 3e-3 (measured 4.8e-4).
- ``adamw_update`` on the same numpy gradients: within 1e-6.  The
  compressors, error feedback, the token stream and the checkpoints: exact.
- The port against itself (remat policies, the restart drill): bit for
  bit.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import checkpoint as j_ckpt  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.data.tokens import TokenStreamSpec as JSpec  # noqa: E402
from repro.data.tokens import batch_for_step as j_batch  # noqa: E402
from repro.launch.train import train as j_train  # noqa: E402
from repro.models import registry as j_registry  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.common import ShapeSpec as JShape  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro.optim import compression as j_comp  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.data.tokens import TokenStreamSpec  # noqa: E402
from repro_torch.data.tokens import batch_for_step  # noqa: E402
from repro_torch.distributed.fault import (FailureInjector,  # noqa: E402
                                           HeartbeatRegistry,
                                           StragglerMonitor,
                                           plan_elastic_mesh)
from repro_torch.kernels.flash_attention import kernel as t_fkernel  # noqa: E402
from repro_torch.kernels.flash_attention import ref as t_fref  # noqa: E402
from repro_torch.launch import train as t_launch  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import registry as t_registry  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.common import ShapeSpec  # noqa: E402
from repro_torch.optim import adamw as t_adamw  # noqa: E402
from repro_torch.optim import compression as t_comp  # noqa: E402
from repro_torch.tree import (key_paths, tree_leaves, tree_map,  # noqa: E402
                              tree_unflatten)
from torch_lm_ref import one_torch_thread  # noqa: E402,F401

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
ARCH = "qwen3-0.6b"
REDUCED = dict(n_layers=2, d_model=64, d_ff=128, n_heads=2, n_kv_heads=1,
               d_head=32, vocab_size=128)
TOL = {"float32": dict(loss=1e-5, grad=1e-5, gnorm=1e-5, steps=5e-5),
       "bfloat16": dict(loss=1e-3, grad=2 ** -4, gnorm=2 ** -5, steps=3e-3)}
ADAMW_TOL = 1e-6


def _cfgs(dtype="float32", **kw):
    kw = {**REDUCED, "compute_dtype": dtype, "cache_dtype": dtype, **kw}
    return j_smoke(ARCH).replace(**kw), t_smoke(ARCH).replace(**kw)


def _jax_params(jcfg, seed=0):
    state, _ = j_registry.get_model_fns(jcfg).init_train_state(
        jcfg, jax.random.key(seed))
    return state["params"]


def _batch(B, S, seed, vocab=128):
    toks = np.random.default_rng(seed).integers(0, vocab, size=(B, S)) \
        .astype(np.int32)
    targets = np.concatenate([toks[:, 1:], np.full((B, 1), -1, np.int32)],
                             axis=1)
    targets[0, 3] = -1                        # a masked position mid-row
    return {"tokens": toks, "targets": targets}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _port_key(jax_tree, key):
    """The JAX leaf (``layers`` stacked) that the port's key path names."""
    flat = dict(key_paths(jax.tree.map(np.asarray, jax_tree)))
    if key.startswith("['layers']["):
        i, rest = key[len("['layers']["):].split("]", 1)
        return flat["['layers']" + rest][int(i)]
    return flat[key]


def _port_grads(tparams, tcfg, batch):
    leaves = [p.detach().requires_grad_() for p in tree_leaves(tparams)]
    loss = TT.loss_fn(tree_unflatten(tparams, leaves), tcfg,
                      {k: torch.as_tensor(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(tparams, list(grads))


# ----------------------------------------------------------- loss, grads ----


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(dtype):
    """Loss and the gradient of every parameter (wq, wk, wv, wo, the MLP,
    the norms and the tied embedding) against jax.value_and_grad."""
    jcfg, tcfg = _cfgs(dtype)
    jp = _jax_params(jcfg)
    tp = TT.params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    batch = _batch(2, 48, 1)
    want_l, want_g = jax.value_and_grad(JT.loss_fn)(
        jp, jcfg, jax.tree.map(jnp.asarray, batch))
    got_l, got_g = _port_grads(tp, tcfg, batch)
    tol = TOL[dtype]
    assert abs(float(got_l) - float(want_l)) <= tol["loss"]
    names = set()
    for key, g in key_paths(got_g):
        want = _port_key(want_g, key)
        assert g.shape == want.shape, key
        np.testing.assert_allclose(_np(g), want, rtol=0,
                                   atol=tol["grad"] * np.abs(want).max(),
                                   err_msg=key)
        names.add(key.rsplit("[", 1)[1])
    assert {"'wq']", "'wk']", "'wv']", "'wo']", "'w1']", "'w2']", "'w3']",
            "'q_norm']", "'k_norm']", "'w']"} <= names


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_metrics_match_jax(dtype, n_micro):
    """One train step, whole batch or two microbatches: loss, grad_norm and
    lr against the JAX package's jitted step on the same parameters."""
    jcfg, tcfg = _cfgs(dtype)
    jp = _jax_params(jcfg)
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=8)
    jstate = {"params": jp, "opt": j_adamw.adamw_init(jp),
              "step": jnp.zeros((), jnp.int32)}
    jstep = jax.jit(JT.make_train_step(jcfg, j_adamw.AdamWConfig(**opt),
                                       n_micro))
    batch = _batch(4, 32, 2)
    _, want = jstep(jstate, jax.tree.map(jnp.asarray, batch))
    tstate = TT.train_state(TT.params_from_reference(
        jax.tree.map(np.asarray, jp), device="cpu"))
    before = tstate["params"]["layers"][0]["attn"]["wq"].clone()
    tstep = TT.make_train_step(tcfg, t_adamw.AdamWConfig(**opt), n_micro)
    tstate, got = tstep(tstate, batch)
    tol = TOL[dtype]
    assert abs(float(got["loss"]) - float(want["loss"])) <= tol["loss"]
    assert abs(float(got["grad_norm"]) / float(want["grad_norm"]) - 1) \
        <= tol["gnorm"]
    assert float(got["lr"]) == pytest.approx(float(want["lr"]), rel=1e-6)
    assert int(tstate["step"]) == 1
    assert not torch.equal(tstate["params"]["layers"][0]["attn"]["wq"],
                           before)


def test_microbatches_average_the_whole_batch():
    """Two microbatches give the whole batch's loss and gradient norm
    (fp32, every target counted: the masks of both halves hold as many
    positions)."""
    _, tcfg = _cfgs("float32")
    tp = TT.init_params(tcfg, 0, device="cpu")
    batch = _batch(4, 16, 3)
    batch["targets"][0, 3] = batch["tokens"][0, 4]
    out = []
    for n in (1, 2):
        state = TT.train_state(tree_map(torch.clone, tp))
        out.append(TT.make_train_step(tcfg, t_adamw.AdamWConfig(), n)(
            state, batch)[1])
    assert float(out[0]["loss"]) == pytest.approx(float(out[1]["loss"]),
                                                  abs=1e-6)
    assert float(out[0]["grad_norm"]) == pytest.approx(
        float(out[1]["grad_norm"]), rel=1e-5)


# ------------------------------------------------- attention in autograd ----


def _grad_fn_names(t):
    seen, names, stack = set(), [], [t.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        stack.extend(f for f, _ in fn.next_functions)
    return names


@pytest.mark.parametrize("policy", ["everything", "dots", "nothing"])
def test_flash_attention_is_in_the_autograd_graph(policy, monkeypatch):
    """Each layer's attention is a FlashAttention node of the loss's graph,
    its forward runs the kernel wrapper (once per layer, twice where the
    policy recomputes the block in the backward), and the attention
    weights get the gradient the plain attention gives them."""
    _, tcfg = _cfgs("float32", remat_policy=policy)
    tp = TT.init_params(tcfg, 0, device="cpu")
    batch = _batch(2, 24, 4)
    calls = []
    real = t_fkernel.flash_attention_plain
    monkeypatch.setattr(t_fkernel, "flash_attention_plain",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    leaves = [p.detach().requires_grad_() for p in tree_leaves(tp)]
    loss = TT.loss_fn(tree_unflatten(tp, leaves), tcfg,
                      {k: torch.as_tensor(v) for k, v in batch.items()})
    assert _grad_fn_names(loss).count("FlashAttentionBackward") \
        == tcfg.n_layers
    assert len(calls) == tcfg.n_layers
    grads = tree_unflatten(tp, list(torch.autograd.grad(loss, leaves)))
    assert len(calls) == tcfg.n_layers * (1 if policy == "everything" else 2)

    monkeypatch.setattr(TL.FlashAttention, "apply",
                        lambda q, k, v, cfg, causal: TL.sdpa_chunked(
                            q, k, v, cfg, causal=causal))
    _, plain = _port_grads(tp, tcfg, batch)
    for name in ("wq", "wk", "wv"):
        g = grads["layers"][0]["attn"][name]
        assert float(g.abs().max()) > 0
        np.testing.assert_allclose(
            g.numpy(), plain["layers"][0]["attn"][name].numpy(), rtol=0,
            atol=1e-5 * float(g.abs().max()))


@pytest.mark.parametrize("S,causal,q_chunk", [
    (64, True, 4096), (250, True, 4096), (600, True, 4096), (64, True, 16),
    (256, False, 4096)])
def test_flash_attention_backward_is_the_plain_gradient(S, causal, q_chunk):
    """dq, dk, dv of the unpadded inputs (Sq padded to the kernel's blocks
    and sliced back) equal autograd through the materialised attention
    (fp32, within 1e-5 of their largest magnitude); G = 2."""
    _, tcfg = _cfgs("float32", q_chunk=q_chunk)
    rng = np.random.default_rng(S)
    f = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32),
                                requires_grad=True)
    q, k, v = f(2, S, 4, 32), f(2, S, 2, 32), f(2, S, 2, 32)
    do = torch.tensor(rng.standard_normal((2, S, 4, 32)).astype(np.float32))
    out = TL.FlashAttention.apply(q, k, v, tcfg, causal)
    got = torch.autograd.grad(out, (q, k, v), do)
    want_o = t_fref.ref_attention_gqa(q, k, v, causal=causal)
    want = torch.autograd.grad(want_o, (q, k, v), do)
    np.testing.assert_allclose(out.detach().numpy(), want_o.detach().numpy(),
                               atol=3e-5)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * float(w.abs().max()))


def test_block_grad_check_catches_a_detached_kernel(monkeypatch):
    """``chip_smoke.py``'s phase-16 check on the smoke block (bf16): the
    gradients through FlashAttention pass GRAD_TOL against the plain
    attention, and a detached kernel output fails it with zero
    gradients."""
    monkeypatch.syspath_prepend(os.path.dirname(SRC))
    import chip_smoke
    tcfg = t_smoke(ARCH).replace(n_layers=1)
    blk = TT.init_params(tcfg, 0, device="cpu")["layers"][0]
    h = torch.randn((2, 96, tcfg.d_model),
                    generator=torch.Generator().manual_seed(1)).bfloat16()
    kernel = lambda q, k, v: TL.FlashAttention.apply(q, k, v, tcfg, True)
    want = chip_smoke.block_attention_grads(
        tcfg, blk, h, lambda q, k, v: t_fref.ref_attention_gqa(q, k, v))
    got = chip_smoke.block_attention_grads(tcfg, blk, h, kernel)
    assert all(v <= 1 for v in chip_smoke.grad_shares(got, want).values())
    detached = chip_smoke.block_attention_grads(
        tcfg, blk, h, lambda q, k, v: kernel(q, k, v).detach())
    assert all(float(g.abs().max()) == 0 for g in detached.values())
    assert all(v > 1 for v in chip_smoke.grad_shares(detached, want)
               .values())


def test_remat_policies_agree():
    """"nothing", "dots" and "everything" give the same loss and gradients,
    bit for bit (bf16)."""
    out = {}
    for policy in ("nothing", "dots", "everything"):
        _, tcfg = _cfgs("bfloat16", remat_policy=policy)
        tp = TT.init_params(tcfg, 1, device="cpu")
        out[policy] = _port_grads(tp, tcfg, _batch(2, 32, 5))
    for policy in ("nothing", "dots"):
        assert torch.equal(out[policy][0], out["everything"][0])
        for a, b in zip(tree_leaves(out[policy][1]),
                        tree_leaves(out["everything"][1])):
            assert torch.equal(a, b), policy


# ---------------------------------------------------------------- AdamW ----


def _opt_tree(rng):
    return {"w": rng.standard_normal((4, 8)).astype(np.float32),
            "b": rng.standard_normal((8,)).astype(np.float32),
            "layers": [{"k": rng.standard_normal((3, 2, 5)).astype(
                np.float32)} for _ in range(2)]}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return {k: ([_t(x) for x in v] if isinstance(v, list) else
                _t(v) if isinstance(v, dict) else torch.tensor(v))
            for k, v in tree.items()}


@pytest.mark.parametrize("case", ["plain", "clipped", "bf16", "int8"])
def test_adamw_update_matches_jax(case):
    """Four steps on the same numpy gradients: parameters, both moments and
    the metrics within 1e-6."""
    rng = np.random.default_rng(7)
    params = _opt_tree(rng)
    cfg = dict(lr=1e-2, weight_decay=0.1, warmup_steps=2, total_steps=10,
               clip_norm=1e9 if case == "plain" else 1.0)
    transform = {"plain": None, "clipped": None, "bf16": "bf16",
                 "int8": "int8"}[case]
    jtr = {"bf16": lambda g: j_comp.decompress_bf16(j_comp.compress_bf16(g)),
           "int8": lambda g: j_comp.decompress_int8(j_comp.compress_int8(g)),
           None: None}[transform]
    jp, jo = _j(params), j_adamw.adamw_init(_j(params))
    tp = _t(params)
    to = t_adamw.adamw_init(tp)
    for step in range(4):
        grads = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 3)
                             .astype(np.float32), params)
        jp, jo, jm = j_adamw.adamw_update(
            j_adamw.AdamWConfig(**cfg), jp, _j(grads), jo, jnp.int32(step),
            grad_transform=jtr)
        tp, to, tm = t_adamw.adamw_update(
            t_adamw.AdamWConfig(**cfg), tp, _t(grads), to,
            torch.tensor(step, dtype=torch.int32),
            grad_transform=t_launch._grad_transform(transform))
        for a, b in ((tp, jp), (to["m"], jo["m"]), (to["v"], jo["v"])):
            for (key, x), y in zip(key_paths(a), jax.tree.leaves(b)):
                np.testing.assert_allclose(_np(x), np.asarray(y), rtol=0,
                                           atol=ADAMW_TOL, err_msg=key)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), abs=1e-9)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
    if case == "clipped":
        assert float(tm["grad_norm"]) > cfg["clip_norm"]


def test_adamw_decays_matrices_only_and_in_place():
    params = {"w": torch.ones((2, 2)), "b": torch.ones((2,))}
    opt = t_adamw.adamw_init(params)
    w = params["w"]
    cfg = t_adamw.AdamWConfig(lr=0.1, weight_decay=1.0, warmup_steps=1,
                              total_steps=10, clip_norm=1e9)
    zero = {"w": torch.zeros((2, 2)), "b": torch.zeros((2,))}
    new, _, _ = t_adamw.adamw_update(cfg, params, zero, opt,
                                     torch.tensor(0, dtype=torch.int32))
    assert new["w"] is w and float(w.max()) < 1.0
    assert float((new["b"] - 1).abs().max()) == 0.0


def test_schedule_matches_jax():
    for kw in (dict(lr=1e-3, warmup_steps=10, total_steps=100),
               dict(lr=3e-4, warmup_steps=1, total_steps=3),
               dict(lr=2e-2, warmup_steps=0, total_steps=1)):
        steps = np.arange(0, 130, dtype=np.int32)
        want = np.asarray(j_adamw.schedule(j_adamw.AdamWConfig(**kw),
                                           jnp.asarray(steps)))
        got = t_adamw.schedule(t_adamw.AdamWConfig(**kw),
                               torch.from_numpy(steps)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_global_norm_matches_jax():
    tree = _opt_tree(np.random.default_rng(3))
    assert float(t_adamw.global_norm(_t(tree))) == pytest.approx(
        float(j_adamw.global_norm(_j(tree))), rel=1e-6)


# ---------------------------------------------------------- compression ----


def test_compressors_match_jax_exactly():
    rng = np.random.default_rng(11)
    g = {"w": (rng.standard_normal((64, 33)) * 5).astype(np.float32),
         "layers": [{"b": rng.standard_normal((17,)).astype(np.float32)}],
         "z": np.zeros((4,), np.float32)}
    bj = j_comp.compress_bf16(_j(g))
    bt = t_comp.compress_bf16(_t(g))
    for x, y in zip(tree_leaves(bt), jax.tree.leaves(bj)):
        assert x.dtype == torch.bfloat16
        np.testing.assert_array_equal(x.float().numpy(),
                                      np.asarray(y.astype(jnp.float32)))
    for x, y in zip(tree_leaves(t_comp.decompress_bf16(bt)),
                    jax.tree.leaves(j_comp.decompress_bf16(bj))):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    qj = j_comp.compress_int8(_j(g))
    qt = t_comp.compress_int8(_t(g))
    pairs_j = jax.tree.leaves(qj, is_leaf=lambda x: isinstance(x, tuple))
    for (q, s), (qq, ss) in zip(tree_leaves(qt), pairs_j):
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(qq))
        assert float(s) == float(ss)
    for x, y in zip(tree_leaves(t_comp.decompress_int8(qt)),
                    jax.tree.leaves(j_comp.decompress_int8(qj))):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_error_feedback_matches_jax_exactly():
    rng = np.random.default_rng(12)
    shape = {"w": np.zeros((256,), np.float32),
             "layers": [{"b": np.zeros((3, 5), np.float32)}]}
    rj = j_comp.init_residual(_j(shape))
    rt = t_comp.init_residual(_t(shape))
    total_true = total_sent = 0.0
    for _ in range(20):
        g = jax.tree.map(lambda x: rng.standard_normal(x.shape)
                         .astype(np.float32), shape)
        sj, rj = j_comp.error_feedback_int8(_j(g), rj)
        st, rt = t_comp.error_feedback_int8(_t(g), rt)
        for x, y in zip(tree_leaves(st) + tree_leaves(rt),
                        jax.tree.leaves(sj) + jax.tree.leaves(rj)):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        total_true = total_true + g["w"]
        total_sent = total_sent + st["w"].numpy()
    drift = np.abs(total_true - total_sent).max()
    assert drift <= np.abs(rt["w"].numpy()).max() + 1e-5


# --------------------------------------------------------- token stream ----


@pytest.mark.parametrize("seed,step,shard,n_shards", [
    (0, 0, 0, 1), (3, 5, 0, 2), (3, 5, 1, 2), (7, 123, 3, 4),
    (2 ** 20, 10 ** 6, 0, 1)])
def test_batch_for_step_byte_identical(seed, step, shard, n_shards):
    kw = dict(vocab_size=151936, seq_len=96, global_batch=8, seed=seed)
    want = j_batch(JSpec(**kw), step, shard=shard, n_shards=n_shards)
    got = batch_for_step(TokenStreamSpec(**kw), step, shard=shard,
                         n_shards=n_shards)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes()


def test_token_stream_restart_contract():
    spec = TokenStreamSpec(vocab_size=512, seq_len=32, global_batch=8, seed=3)
    a, b, c = (batch_for_step(spec, s) for s in (5, 5, 6))
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], c["tokens"])
    np.testing.assert_array_equal(a["targets"][:, :-1], a["tokens"][:, 1:])
    assert (a["targets"][:, -1] == -1).all()
    assert batch_for_step(spec, 5, shard=0, n_shards=2)["tokens"].shape \
        == (4, 32)


# ------------------------------------------------------------- registry ----


def test_registry_training_entries():
    jcfg, tcfg = _cfgs()
    fns = t_registry.get_model_fns(tcfg)
    assert fns.loss_fn is TT.loss_fn
    state, axes = fns.init_train_state(tcfg, 0, "cpu")
    _, j_axes = j_registry.get_model_fns(jcfg).init_train_state(
        jcfg, jax.random.key(0))
    assert axes == j_axes and set(state) == {"params", "opt", "step"}
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    for key, m in key_paths(state["opt"]["m"]):
        assert m.dtype == torch.float32 and float(m.abs().max()) == 0, key
    step = fns.make_train_step(tcfg, t_adamw.AdamWConfig(), 1)
    state, metrics = step(state, _batch(2, 16, 0))
    assert int(state["step"]) == 1 and np.isfinite(float(metrics["loss"]))
    for name in ("train_4k", "prefill_32k"):
        kind = name.split("_")[0]
        jshape, tshape = JShape(name, 64, 4, kind), ShapeSpec(name, 64, 4, kind)
        want = j_registry.batch_specs(jcfg, jshape)
        got = t_registry.batch_specs(tcfg, tshape)
        assert set(got) == set(want)
        for k, v in got.items():
            assert v.device.type == "meta" and v.dtype == torch.int32
            assert tuple(v.shape) == tuple(want[k].shape)
        want = j_registry.synth_batch(jcfg, jshape, seed=4)
        got = t_registry.synth_batch(tcfg, tshape, seed=4)
        assert set(got) == set(want)
        for k in want:
            assert got[k].tobytes() == np.asarray(want[k]).tobytes()


# ---------------------------------------------------------- checkpoints ----


def _tiny_state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((4, 8), generator=g),
                       "b": torch.zeros((8,)),
                       "layers": [{"k": torch.randn((3,), generator=g)}
                                  for _ in range(2)]},
            "opt": {"m": {"w": torch.ones((4, 8)), "b": torch.zeros((8,))}},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_save_restore_roundtrip(tmp_path):
    state = _tiny_state()
    ckpt.save(str(tmp_path), 7, state)
    restored, step = ckpt.restore(str(tmp_path), state)
    assert step == 7
    for (k, a), (_, b) in zip(key_paths(state), key_paths(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b), k


def test_keep_k_cleanup(tmp_path):
    for s in range(5):
        ckpt.save(str(tmp_path), s, _tiny_state(), keep=2)
    assert ckpt.all_steps(str(tmp_path)) == [3, 4]
    assert ckpt.latest_step(str(tmp_path)) == 4


def test_restore_rejects_shape_mismatch(tmp_path):
    ckpt.save(str(tmp_path), 0, {"w": torch.zeros((4,))})
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), {"w": torch.zeros((5,))})


def test_restore_rejects_missing_leaf(tmp_path):
    ckpt.save(str(tmp_path), 0, {"w": torch.zeros((4,))})
    with pytest.raises(KeyError):
        ckpt.restore(str(tmp_path), {"w": torch.zeros((4,)),
                                     "extra": torch.zeros((2,))})


def test_restore_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path), {"w": torch.zeros((4,))})


def test_atomicity_no_tmp_left(tmp_path):
    ckpt.save(str(tmp_path), 3, _tiny_state())
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    assert sorted(os.listdir(tmp_path / "step_00000003")) == [
        "arrays.npz", "manifest.json"]


def test_async_checkpointer(tmp_path):
    w = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    state = _tiny_state()
    for s in (10, 20):
        w.save(s, state)
    w.wait()
    assert ckpt.latest_step(str(tmp_path)) == 20


def test_async_checkpointer_snapshots_before_returning(tmp_path):
    """The optimizer updates the state in place right after save: the
    checkpoint holds the values at save time."""
    w = ckpt.AsyncCheckpointer(str(tmp_path))
    state = _tiny_state()
    old = {k: v.clone() for k, v in key_paths(state)}
    w.save(1, state)
    for leaf in tree_leaves(state):
        leaf.add_(1)
    w.wait()
    restored, _ = ckpt.restore(str(tmp_path), state)
    for k, v in key_paths(restored):
        assert torch.equal(v, old[k]), k


def test_restore_places_leaves_by_template(tmp_path):
    """Each leaf takes the template's dtype (bf16 stored as fp32, exactly)
    and device."""
    bf = torch.tensor([1.5, -2.25, 3.0078125], dtype=torch.bfloat16)
    ckpt.save(str(tmp_path), 0, {"a": bf, "b": torch.arange(3)})
    got, _ = ckpt.restore(str(tmp_path), {"a": torch.zeros(3, dtype=torch.bfloat16),
                                          "b": torch.zeros(3)})
    assert got["a"].dtype == torch.bfloat16 and torch.equal(got["a"], bf)
    assert got["b"].dtype == torch.float32
    assert all(t.device.type == "cpu" for t in got.values())
    with open(tmp_path / "step_00000000" / "manifest.json") as f:
        assert json.load(f)["leaves"]["['a']"]["dtype"] == "float32"


def test_checkpoints_cross_both_packages(tmp_path):
    """A port checkpoint of a training state restores through
    repro.checkpoint into a JAX tree of the same structure, and a JAX
    checkpoint restores into the port's template, leaves equal."""
    _, tcfg = _cfgs()
    state = TT.train_state(TT.init_params(tcfg, 2, device="cpu"))
    state, _ = TT.make_train_step(tcfg, t_adamw.AdamWConfig(), 1)(
        state, _batch(2, 16, 1))
    ckpt.save(str(tmp_path / "port"), 1, state)
    template = jax.tree.map(lambda t: jnp.zeros(t.shape, t.numpy().dtype),
                            state, is_leaf=lambda x: isinstance(
                                x, torch.Tensor))
    got, step = j_ckpt.restore(str(tmp_path / "port"), template)
    assert step == 1
    assert len(jax.tree.leaves(got)) == len(tree_leaves(state))
    for (k, a), b in zip(key_paths(state), jax.tree.leaves(got)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=k)

    jstate = jax.tree.map(lambda t: jnp.asarray(t.numpy() + 1), state,
                          is_leaf=lambda x: isinstance(x, torch.Tensor))
    j_ckpt.save(str(tmp_path / "jax"), 5, jstate)
    got, step = ckpt.restore(str(tmp_path / "jax"), state)
    assert step == 5
    for (k, a), b in zip(key_paths(got), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=k)


# ---------------------------------------------------------------- fault ----


def test_straggler_detection():
    mon = StragglerMonitor(n_workers=8, factor=2.0)
    for _ in range(4):
        for w in range(8):
            mon.record(w, 1.0 if w != 5 else 4.0)
    assert mon.stragglers() == [5]
    plan = mon.reassignment()
    assert [s for ss in plan.values() for s in ss] == [5]
    assert all(w != 5 for w in plan)


def test_straggler_none_when_uniform():
    mon = StragglerMonitor(n_workers=4)
    for w in range(4):
        mon.record(w, 1.0)
    assert mon.stragglers() == [] and mon.reassignment() == {}


def test_heartbeat_dead_detection():
    hb = HeartbeatRegistry(n_workers=3, timeout_s=10.0)
    now = 1000.0
    for w in range(3):
        hb.ping(w, at=now)
    assert hb.dead(now + 5) == []
    hb.ping(0, at=now + 20)
    hb.ping(2, at=now + 20)
    assert hb.dead(now + 20) == [1]
    assert hb.healthy_count(now + 20) == 2


def test_elastic_mesh_plans():
    assert plan_elastic_mesh(512, model_parallel=16, pods=2) == (
        (2, 16, 16), ("pod", "data", "model"))
    assert plan_elastic_mesh(472, model_parallel=16, pods=2)[0] == (2, 8, 16)
    assert plan_elastic_mesh(256, model_parallel=16, pods=1) == (
        (16, 16), ("data", "model"))
    with pytest.raises(ValueError):
        plan_elastic_mesh(8, model_parallel=16, pods=1)


def test_injector_fires_only_at_step():
    inj = FailureInjector(3)
    inj.check(2)
    with pytest.raises(FailureInjector.SimulatedFailure):
        inj.check(3)
    FailureInjector(None).check(3)


# ------------------------------------------------------ the slice whole ----


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_three_steps_matches_jax(dtype):
    """JAX ``train`` and the port's from the same initial parameters on the
    shared token stream: per-step losses within the stated tolerance."""
    jcfg, tcfg = _cfgs(dtype)
    kw = dict(steps=3, global_batch=2, seq_len=32, log_every=100)
    opt = dict(lr=1e-3, total_steps=3, warmup_steps=1)
    _, want = j_train(jcfg, opt_cfg=j_adamw.AdamWConfig(**opt), **kw)
    params = jax.tree.map(np.asarray, _jax_params(jcfg))
    state, got = t_launch.train(tcfg, opt_cfg=t_adamw.AdamWConfig(**opt),
                                params=params, device="cpu", **kw)
    assert len(got) == 3 and int(state["step"]) == 3
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype]["steps"])


def test_restart_continuation_bit_identical(tmp_path):
    """Train 8 steps straight against train -> simulated failure at step 5
    -> resume from the step-3 checkpoint: final parameters, moments and
    step bit for bit (the stream is keyed by step)."""
    _, tcfg = _cfgs("bfloat16")
    opt = t_adamw.AdamWConfig(lr=1e-3, total_steps=8, warmup_steps=2)
    kw = dict(steps=8, global_batch=2, seq_len=32, opt_cfg=opt,
              log_every=100, device="cpu")
    ref, losses_ref = t_launch.train(tcfg, **kw)
    d = str(tmp_path / "a")
    with pytest.raises(FailureInjector.SimulatedFailure):
        t_launch.train(tcfg, ckpt_dir=d, ckpt_every=4, fail_at_step=5, **kw)
    assert ckpt.latest_step(d) == 3
    res, losses_res = t_launch.train(tcfg, ckpt_dir=d, ckpt_every=4,
                                     resume=True, **kw)
    assert losses_res == losses_ref[4:]
    for (k, a), (_, b) in zip(key_paths(ref), key_paths(res)):
        assert torch.equal(a, b), k
    assert ckpt.latest_step(d) == 7


def test_entry_points_default_to_the_card(monkeypatch):
    _, tcfg = _cfgs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (lambda: TT.init_train_state(tcfg),
               lambda: t_registry.get_model_fns(tcfg).init_train_state(tcfg),
               lambda: t_launch.train(tcfg, steps=1, global_batch=1,
                                      seq_len=8),
               lambda: t_launch.main(["--arch", ARCH + "-smoke",
                                      "--steps", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


def _run_without_jax(module, args, tmp_path):
    code = (
        "import runpy, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"sys.argv = [{module!r}] + {args!r}\n"
        "try:\n"
        f"    runpy.run_module({module!r}, run_name='__main__')\n"
        "finally:\n"
        "    bad = [m for m in sys.modules if sys.modules[m] is not None and"
        " (m.split('.')[0] in ('jax', 'repro'))]\n"
        "    assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=SRC, TMPDIR=str(tmp_path),
               OMP_NUM_THREADS="1")     # as one_torch_thread
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)


def test_launcher_and_example_on_cpu_without_jax(tmp_path):
    """``python -m repro_torch.launch.train --device cpu`` trains, fails
    with exit code 42 at a simulated failure and resumes;
    ``repro_torch.examples.train_lm --device cpu`` trains; JAX unimportable
    throughout."""
    base = ["--device", "cpu", "--arch", ARCH + "-smoke", "--steps", "4",
            "--seq", "32", "--global-batch", "2", "--log-every", "1",
            "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2"]
    out = _run_without_jax("repro_torch.launch.train",
                           base + ["--simulate-failure", "2"], tmp_path)
    assert out.returncode == 42, out.stderr
    assert "simulated node failure at step 2" in out.stdout
    out = _run_without_jax("repro_torch.launch.train", base + ["--resume"],
                           tmp_path)
    assert out.returncode == 0, out.stderr
    assert "[train] resumed from step 1" in out.stdout
    assert "[train] step     3 loss" in out.stdout
    out = _run_without_jax("repro_torch.examples.train_lm",
                           ["--device", "cpu", "--arch", ARCH + "-smoke",
                            "--steps", "2", "--seq", "32"], tmp_path)
    assert out.returncode == 0, out.stderr
    assert "[train] step     1 loss" in out.stdout
    assert os.listdir(tmp_path / "repro_torch_train_100m") != []


def test_train_probe_on_cpu_without_jax(tmp_path):
    """``python -m repro_torch.launch.train_probe --device cpu`` on the smoke
    model prints its three probes (remat policies, AdamW alone, the indexed
    embedding's determinism); JAX unimportable."""
    out = _run_without_jax("repro_torch.launch.train_probe",
                           ["--device", "cpu", "--arch", ARCH + "-smoke",
                            "--batch", "2", "--seq", "32"], tmp_path)
    assert out.returncode == 0, out.stderr
    lines = [x for x in out.stdout.splitlines() if x.startswith("[probe]")]
    assert len(lines) == 3 and all(x.endswith("device: cpu") for x in lines)
    assert all(f"{p} " in lines[0] for p in ("dots", "everything", "nothing"))
    assert "bit-identical in three passes: True" in lines[2]

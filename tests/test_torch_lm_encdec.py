"""The port's enc-dec family (whisper: an encoder over stubbed frame
embeddings, a decoder with self- and cross-attention, sinusoidal positions)
equals the JAX package's, whole model.

Model: ``smoke_config("whisper-base")`` (2 encoder layers over 64 frames, 4
decoder layers, d 256, GQA 4/2, dh 64, vocab 512).  Parameters are the JAX
package's own (``init_train_state``), handed over by
``params_from_reference`` (``enc_layers`` and ``layers`` unstacked);
tokens and frames from a seeded numpy RNG.  The encoder's self-attention,
the decoder's and the cross-attention run through the flash kernel's plain
version (non-causal ones over the 64 keys unpadded); the JAX package runs
``_sdpa``.

Tolerances are the dense tests' (``tests/test_torch_lm.py``,
``tests/test_torch_train.py``): logits within 1e-4 (fp32) and 2**-5 of the
largest magnitude (bf16); caches within 1e-5 / 2**-5; the loss within
1e-5 / 1e-3; every gradient within 1e-5 / 2**-4 of its largest magnitude;
``grad_norm`` within 1e-5 / 2**-5 relative; greedy tokens equal in fp32.
The JAX package's results are jitted and computed once per dtype
(``tests/torch_lm_ref.py``).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import checkpoint as j_ckpt  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import encdec as JE  # noqa: E402
from repro.models import registry as j_registry  # noqa: E402
from repro.models.common import ShapeSpec as JShape  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import get_config as t_get  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as t_kernel  # noqa: E402
from repro_torch.models import encdec as TE  # noqa: E402
from repro_torch.models import registry as t_registry  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.common import ShapeSpec  # noqa: E402
from repro_torch.optim import adamw as t_adamw  # noqa: E402
from repro_torch.tree import key_paths, tree_leaves  # noqa: E402
from torch_lm_ref import (SRC, close, jax_grads, jax_params,  # noqa: E402
                          jit_call, launcher_cases, lm_batch, memo,
                          n_port_leaves, one_torch_thread, port_grads,
                          port_key, run_launchers, scalar_close, tokens)

ARCH = "whisper-base"
TOL = {"float32": dict(logits=dict(atol=1e-4), cache=dict(atol=1e-5),
                       loss=1e-5, grad=1e-5, gnorm=1e-5),
       "bfloat16": dict(logits=dict(scale=2 ** -5), cache=dict(scale=2 ** -5),
                        loss=1e-3, grad=2 ** -4, gnorm=2 ** -5)}


def _cfgs(dtype):
    kw = dict(compute_dtype=dtype, cache_dtype=dtype)
    return j_smoke(ARCH).replace(**kw), t_smoke(ARCH).replace(**kw)


def _frames(B, seed, T=64, D=256):
    return np.random.default_rng(seed).standard_normal((B, T, D)).astype(
        np.float32)


class Pair:
    """One dtype: both configs, the JAX parameters and the port's."""

    def __init__(self, dtype):
        self.dtype = dtype
        self.jcfg, self.tcfg = _cfgs(dtype)
        self.jp = jax_params(self.jcfg, ARCH)
        self.tp = TT.params_from_reference(
            jax.tree.map(np.asarray, self.jp), device="cpu")

    def jax(self, name, fn):
        """``fn()``, once per dtype and name."""
        return memo((ARCH, self.dtype, name), fn)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    return Pair(request.param)


def test_params_from_reference(pair):
    """Every JAX leaf arrives bit for bit, ``enc_layers`` and ``layers``
    unstacked into lists of blocks."""
    cfg = pair.tcfg
    assert len(pair.tp["enc_layers"]) == cfg.enc_layers == 2
    assert len(pair.tp["layers"]) == cfg.n_layers == 4
    assert set(pair.tp["enc_layers"][0]) == {"ln1", "ln2", "attn", "mlp"}
    assert set(pair.tp["layers"][0]) == {"ln1", "lnx", "ln2", "attn",
                                         "xattn", "mlp"}
    assert len(key_paths(pair.tp)) == n_port_leaves(pair.jp)
    for key, t in key_paths(pair.tp):
        np.testing.assert_array_equal(t.numpy(), port_key(pair.jp, key),
                                      err_msg=key)


def test_forward(pair):
    toks, frames = tokens(2, 12, 1), _frames(2, 1)
    want, _ = pair.jax("forward", lambda: jit_call(
        JE.forward, pair.jcfg, pair.jp, jnp.asarray(toks),
        jnp.asarray(frames)))
    got, aux = TE.forward(pair.tp, pair.tcfg, torch.as_tensor(toks).long(),
                          torch.as_tensor(frames))
    assert tuple(got.shape) == (2, 12, pair.tcfg.vocab_padded)
    assert got.dtype == pair.tcfg.cdtype() and float(aux) == 0.0
    assert bool(torch.isfinite(got).all())
    close(got, want, TOL[pair.dtype]["logits"])
    enc = TE.encode(pair.tp, pair.tcfg, torch.as_tensor(frames))
    close(enc, jit_call(JE.encode, pair.jcfg, pair.jp, jnp.asarray(frames)),
          TOL[pair.dtype]["cache"] if pair.dtype == "bfloat16"
          else dict(atol=1e-4), "encoder states")


def _jax_prefill(pair, S, seed):
    toks, frames = tokens(2, S, seed), _frames(2, seed)
    return toks, frames, pair.jax(f"prefill{S}", lambda: jit_call(
        JE.prefill, pair.jcfg, pair.jp, jnp.asarray(toks),
        jnp.asarray(frames)))


def test_prefill_and_cache(pair):
    """Prefill logits and the four caches: the decoder's K/V, S rows, and
    the cross-attention's K/V over the 64 frames, in the cache dtype."""
    toks, frames, (want, jc) = _jax_prefill(pair, 10, 2)
    got, tc = TE.prefill(pair.tp, pair.tcfg, torch.as_tensor(toks).long(),
                         torch.as_tensor(frames))
    assert got.dtype == torch.float32
    close(got, want, TOL[pair.dtype]["logits"])
    assert set(tc) == set(jc) == {"k", "v", "ck", "cv"}
    for key in jc:
        assert tuple(tc[key].shape) == tuple(jc[key].shape), key
        assert tc[key].dtype == getattr(torch, pair.dtype), key
        close(tc[key], jc[key], TOL[pair.dtype]["cache"], key)
    assert tuple(tc["ck"].shape) == (4, 2, 64, 2, 64)


def test_serve_step(pair):
    """Prefill 10 tokens into a 16-row cache (K/V along the sequence axis,
    the cross caches whole), then two decode steps: logits and caches."""
    toks, frames, (_, jpc) = _jax_prefill(pair, 10, 2)

    def jax_steps():
        jc = JE.init_cache(pair.jcfg, 2, 16)
        jc = {k: jax.lax.dynamic_update_slice_in_dim(v, jpc[k], 0, axis=2)
              for k, v in jc.items()}
        step = jax.jit(lambda p, c, t, n: JE.serve_step(p, pair.jcfg, c, t,
                                                        n))
        out = []
        for i, tok in enumerate(([5, 300], [17, 2])):
            logits, jc = step(pair.jp, jc, jnp.asarray(tok, jnp.int32),
                              jnp.int32(10 + i))
            out.append((logits, jc))
        return out

    want = pair.jax("serve_step", jax_steps)
    _, pc = TE.prefill(pair.tp, pair.tcfg, torch.as_tensor(toks).long(),
                       torch.as_tensor(frames))
    tc = TE.init_cache(pair.tcfg, 2, 16, device="cpu")
    for k, small in pc.items():
        rows = 16 if k in ("k", "v") else 64      # the cross caches whole
        assert tuple(tc[k].shape) == (4, 2, rows, 2, 64), k
        assert tuple(small.shape) == (4, 2, 10 if rows == 16 else 64, 2, 64)
        assert tc[k].dtype == small.dtype, k
        tc[k][tuple(slice(0, n) for n in small.shape)] = small
    tol = TOL[pair.dtype]
    for i, tok in enumerate(([5, 300], [17, 2])):
        got, tc = TE.serve_step(pair.tp, pair.tcfg, tc, torch.tensor(tok),
                                10 + i)
        jl, jc = want[i]
        assert tuple(got.shape) == (2, pair.tcfg.vocab_padded)
        close(got, jl, tol["logits"], f"step {i}")
        for key in tc:
            close(tc[key], jc[key], tol["cache"], key)


def _batch():
    b = lm_batch(2, 16, 4)
    b["frames"] = _frames(2, 4)
    return b


def test_loss_and_grads(pair):
    """The loss and the gradient of every parameter (encoder and decoder
    blocks, the cross-attention's, norms, the tied embedding) against
    ``jax.value_and_grad``, under the model's ``"dots"`` remat."""
    assert pair.tcfg.remat_policy == "dots"
    batch = _batch()
    want_l, want_g = pair.jax("grads", lambda: jax_grads(
        JE.loss_fn, pair.jp, pair.jcfg, batch))
    got_l, got_g = port_grads(TE.loss_fn, pair.tp, pair.tcfg, batch)
    tol = TOL[pair.dtype]
    scalar_close(got_l, want_l, tol["loss"])
    keys = [key for key, _ in key_paths(got_g)]
    assert len(keys) == n_port_leaves(pair.jp)
    for key, g in key_paths(got_g):
        want = port_key(want_g, key)
        assert g.shape == want.shape, key
        assert float(np.abs(want).max()) > 0, key
        close(g, want, dict(scale=tol["grad"]), key)
    for part in ("['enc_layers'][1]['attn']", "['layers'][3]['xattn']",
                 "['enc_norm']", "['embed']"):
        assert any(k.startswith(part) for k in keys), part


def test_train_step(pair):
    """One AdamW step: loss, grad_norm and lr against the JAX package's
    step on the same parameters and batch (``adamw_update`` on the
    gradients of :func:`test_loss_and_grads`, as its ``make_train_step``
    does at one microbatch); the step counts and every parameter moves."""
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=8)
    batch = _batch()
    loss, grads = pair.jax("grads", lambda: jax_grads(
        JE.loss_fn, pair.jp, pair.jcfg, batch))
    update = jax.jit(lambda p, g: j_adamw.adamw_update(
        j_adamw.AdamWConfig(**opt), p, g, j_adamw.adamw_init(p),
        jnp.zeros((), jnp.int32))[2])
    want = {"loss": loss, **update(pair.jp, grads)}
    fns = t_registry.get_model_fns(pair.tcfg)
    tstate = TT.train_state(TT.params_from_reference(
        jax.tree.map(np.asarray, pair.jp), device="cpu"))
    before = [t.clone() for t in tree_leaves(tstate["params"])]
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


def test_generate_greedy_tokens_fp32():
    """Prefill over 4-token prompts, then 8 greedy decode steps in a
    16-row cache (the JAX package drives enc-dec serving through
    ``prefill`` / ``serve_step``; its serve launcher refuses enc-dec): the
    same tokens, fp32."""
    p = Pair("float32")
    toks, frames = tokens(3, 4, 6), _frames(3, 6)

    def run_jax():
        logits, pc = jit_call(JE.prefill, p.jcfg, p.jp, jnp.asarray(toks),
                              jnp.asarray(frames))
        c = JE.init_cache(p.jcfg, 3, 16)
        c = {k: jax.lax.dynamic_update_slice_in_dim(v, pc[k], 0, axis=2)
             for k, v in c.items()}
        step = jax.jit(lambda pr, c, t, n: JE.serve_step(pr, p.jcfg, c, t, n))
        out = [np.asarray(logits.argmax(-1))]
        for i in range(7):
            logits, c = step(p.jp, c, jnp.asarray(out[-1], jnp.int32),
                             jnp.int32(4 + i))
            out.append(np.asarray(logits.argmax(-1)))
        return np.stack(out, 1)

    want = run_jax()
    logits, pc = TE.prefill(p.tp, p.tcfg, torch.as_tensor(toks).long(),
                            torch.as_tensor(frames))
    c = TE.init_cache(p.tcfg, 3, 16, device="cpu")
    for k, small in pc.items():
        c[k][tuple(slice(0, n) for n in small.shape)] = small
    got = [logits.argmax(-1)]
    for i in range(7):
        logits, c = TE.serve_step(p.tp, p.tcfg, c, got[-1], 4 + i)
        got.append(logits.argmax(-1))
    np.testing.assert_array_equal(torch.stack(got, 1).numpy(), want)


def test_registry_batches_and_cache():
    """The registry's enc-dec functions, ``batch_specs`` (frames in the
    compute dtype) and ``synth_batch`` (the JAX package's numbers for the
    same seed), and ``init_cache``."""
    jcfg, tcfg = _cfgs("bfloat16")
    fns = t_registry.get_model_fns(tcfg)
    assert (fns.init_params, fns.loss_fn, fns.prefill, fns.serve_step,
            fns.init_cache, fns.forward) == (
        TE.init_params, TE.loss_fn, TE.prefill, TE.serve_step, TE.init_cache,
        TE.forward)
    cache = fns.init_cache(tcfg, 2, 16, "cpu")
    jcache = JE.init_cache(jcfg, 2, 16)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in cache.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in jcache.items()}
    for name in ("train_4k", "prefill_32k"):
        kind = name.split("_")[0]
        jshape, tshape = JShape(name, 64, 4, kind), ShapeSpec(name, 64, 4,
                                                              kind)
        want = j_registry.batch_specs(jcfg, jshape)
        got = t_registry.batch_specs(tcfg, tshape)
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in got.items()} == {
            k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
        want = j_registry.synth_batch(jcfg, jshape, seed=4)
        got = t_registry.synth_batch(tcfg, tshape, seed=4)
        assert set(got) == set(want) >= {"tokens", "frames"}
        for k in want:
            assert got[k].dtype == np.asarray(want[k]).dtype, k
            assert got[k].tobytes() == np.asarray(want[k]).tobytes(), k


def test_init_params_layout():
    """The port's seeded init: the JAX package's tree and leaf count, the
    tied embedding, and whisper-base's published count (70.7 M)."""
    cfg = t_smoke(ARCH)
    p = TE.init_params(cfg, 0, device="cpu")
    jp = Pair("float32").jp
    assert sum(t.numel() for t in tree_leaves(p)) == sum(
        x.size for x in jax.tree.leaves(jp))
    assert len(key_paths(p)) == n_port_leaves(jp)
    assert "unembed" not in p
    assert abs(float(p["embed"]["w"].std()) - 0.02) < 1e-3
    assert t_get(ARCH).param_count() == 70663168
    with pytest.raises(ValueError, match="not enc-dec"):
        TE.init_params(t_smoke("qwen3-0.6b"), 0, device="cpu")


def test_checkpoint_roundtrip_both_ways(tmp_path):
    """The smoke model's training state (``enc_layers`` beside ``layers``):
    a port checkpoint restores through ``repro.checkpoint`` into a JAX
    tree of the same structure, and a JAX checkpoint into the port's
    template, leaves equal."""
    _, tcfg = _cfgs("float32")
    fns = t_registry.get_model_fns(tcfg)
    state, _ = fns.init_train_state(tcfg, 2, "cpu")
    b = lm_batch(2, 8, 1)
    b["frames"] = _frames(2, 1)
    state, _ = fns.make_train_step(tcfg, t_adamw.AdamWConfig(), 1)(state, b)
    assert any("['enc_layers'][1]" in k for k, _ in key_paths(state))
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


def test_launchers_on_cpu_without_jax(tmp_path):
    """``launch.train`` trains whisper's smoke model on zero frames with
    ``--device cpu``; ``launch.serve`` refuses enc-dec with exit code 2,
    as the JAX launcher does; JAX unimportable."""
    out = run_launchers(launcher_cases(ARCH), tmp_path)
    rc, text = out[f"train {ARCH}"]
    assert rc == 0 and "[train] step     1 loss" in text
    rc, text = out[f"serve {ARCH}"]
    assert rc == 2 and "[serve]" not in text


def test_attention_runs_the_flash_kernel(monkeypatch):
    """A prefill calls the kernel's plain version once per encoder layer
    (non-causal, 64 keys unpadded) and twice per decoder layer (causal
    self-attention; non-causal cross-attention over the 64 frames); a
    decode step never."""
    p = Pair("float32")
    seen = []
    real = t_kernel.flash_attention_plain
    monkeypatch.setattr(t_kernel, "flash_attention_plain", lambda q, k, v,
                        **kw: seen.append((q.shape[1], k.shape[1],
                                           kw["causal"])) or real(q, k, v,
                                                                  **kw))
    _, pc = TE.prefill(p.tp, p.tcfg, torch.as_tensor(tokens(1, 5, 3)).long(),
                       torch.as_tensor(_frames(1, 3)))
    assert seen == [(128, 64, False)] * 2 + [(128, 128, True),
                                             (128, 64, False)] * 4
    c = TE.init_cache(p.tcfg, 1, 8, device="cpu")
    for k, small in pc.items():
        c[k][tuple(slice(0, n) for n in small.shape)] = small
    TE.serve_step(p.tp, p.tcfg, c, torch.tensor([3]), 5)
    assert len(seen) == 10


# The smoke model's bounds for chip_smoke's check, between what a sound
# decode gives here (bf16 0.0088 / 0.0015, fp32 9.5e-7 / 1.1e-7) and what
# the planted fault gives (0.205 / 0.047 in both dtypes), about 5x from
# each in bf16.
SMOKE_E2E_TOL = {"bfloat16": {"max": 0.04, "mean": 0.008},
                 "float32": {"max": 1e-3, "mean": 1e-4}}


def test_prefill_decode_matches_forward(monkeypatch):
    """The end-to-end check ``chip_smoke.py`` makes at published widths,
    on the smoke model, in bf16 and fp32: prefill + greedy decode logits
    against one ``forward`` over the prompt and the decoded tokens within
    the bounds; a decode whose cross-attention reads the next request's
    encoder states (the planted fault) exceeds them all."""
    monkeypatch.syspath_prepend(os.path.dirname(SRC))
    import chip_smoke

    frames = torch.as_tensor(_frames(2, 7))
    prompts = tokens(2, 4, 7)

    def run(fault):
        out = {}
        for dtype in SMOKE_E2E_TOL:
            _, cfg = _cfgs(dtype)
            params = TE.init_params(cfg, 0, device="cpu")
            out[dtype] = chip_smoke.encdec_e2e(cfg, params, frames, prompts,
                                               new=12, device="cpu",
                                               fault=fault)
        return out

    good, bad = run(False), run(True)
    assert good["float32"]["positions"] == 12
    chip_smoke.check_e2e(ARCH, good, SMOKE_E2E_TOL)
    chip_smoke.check_e2e(ARCH, bad, SMOKE_E2E_TOL, fault="rolled caches")
    with pytest.raises(AssertionError, match="!= forward"):
        chip_smoke.check_e2e(ARCH, bad, SMOKE_E2E_TOL)
    with pytest.raises(AssertionError, match="passed a"):
        chip_smoke.check_e2e(ARCH, good, SMOKE_E2E_TOL, fault="none")

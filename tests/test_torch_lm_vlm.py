"""The port's VLM family (qwen2-vl: patch embeddings in place of the first
token embeddings, M-RoPE over temporal, height and width sections) equals
the JAX package's, whole model.

Model: ``smoke_config("qwen2-vl-7b")`` (4 layers, d 256, GQA 4/2, dh 64,
M-RoPE sections (8, 12, 12), untied embeddings, vocab 512).  Parameters
are the JAX package's own (``init_train_state``), handed over by
``params_from_reference``; tokens and 16 patch embeddings from a seeded
numpy RNG.  The M-RoPE positions lay the patches out on a 4 x 4 grid
(temporal 0, height the row, width the column) with the text after it from
4 on, equal in the three sections (``chip_smoke.mrope_grid_positions``,
qwen2-vl's layout of an image followed by text), so the three sections
differ on the image.  ``serve_step`` takes each new token's positions.

Tolerances are the dense tests' (``tests/test_torch_lm.py``,
``tests/test_torch_train.py``): logits within 1e-4 (fp32) and 2**-5 of the
largest magnitude (bf16); caches within 1e-5 / 2**-5; the loss within
1e-5 / 1e-3; every gradient within 1e-5 / 2**-4 of its largest magnitude;
``grad_norm`` within 1e-5 / 2**-5 relative; greedy tokens equal in fp32.
The JAX package's results are jitted and computed once per dtype
(``tests/torch_lm_ref.py``).
"""
import importlib.util
import os
import sys

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


def _chip_smoke():
    """``chip_smoke.py`` at the repo's root, the module the card runs."""
    if "chip_smoke" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", os.path.join(os.path.dirname(SRC), "chip_smoke.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules["chip_smoke"] = module
    return sys.modules["chip_smoke"]


chip_smoke = _chip_smoke()
mrope_grid_positions = chip_smoke.mrope_grid_positions

ARCH = "qwen2-vl-7b"
GRID = 4                      # 16 patches, the smoke config's n_patches
TOL = {"float32": dict(logits=dict(atol=1e-4), cache=dict(atol=1e-5),
                       loss=1e-5, grad=1e-5, gnorm=1e-5),
       "bfloat16": dict(logits=dict(scale=2 ** -5), cache=dict(scale=2 ** -5),
                        loss=1e-3, grad=2 ** -4, gnorm=2 ** -5)}


def _cfgs(dtype):
    kw = dict(compute_dtype=dtype, cache_dtype=dtype)
    return j_smoke(ARCH).replace(**kw), t_smoke(ARCH).replace(**kw)


def _image(B, S, seed):
    """(patch embeddings [B, 16, 256], M-RoPE positions [B, S, 3])."""
    patches = np.random.default_rng(seed).standard_normal(
        (B, GRID * GRID, 256)).astype(np.float32)
    return patches, mrope_grid_positions(B, S, GRID)


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


def _kw(patches, mpos, lib):
    """The image's keywords for ``lib`` (jnp or torch)."""
    conv = jnp.asarray if lib is jnp else torch.as_tensor
    return {"patch_embeds": conv(patches), "mrope_pos": conv(mpos)}


def test_params_from_reference(pair):
    """Every JAX leaf arrives bit for bit, ``layers`` unstacked; the
    unembedding is its own matrix."""
    assert len(pair.tp["layers"]) == pair.tcfg.n_layers == 4
    assert "unembed" in pair.tp and not pair.tcfg.tie_embeddings
    assert len(key_paths(pair.tp)) == n_port_leaves(pair.jp)
    for key, t in key_paths(pair.tp):
        np.testing.assert_array_equal(t.numpy(), port_key(pair.jp, key),
                                      err_msg=key)


def test_positions_differ_across_sections():
    """The test image's M-RoPE positions: the three sections differ on the
    patches (so each section's slots turn by their own positions), agree
    on the text, which goes on from the grid's largest position + 1."""
    _, mpos = _image(1, 24, 0)
    img = mpos[0, :GRID * GRID]
    assert (img[:, 0] == 0).all() and len(set(map(tuple, img))) == 16
    assert (img[:, 1] != img[:, 2]).any()
    assert (mpos[0, 16:] == np.arange(4, 12)[:, None]).all()


def test_forward(pair):
    """Forward with an image and text (patches in the first 16 positions,
    M-RoPE), and text alone (plain RoPE), as the JAX package runs it."""
    toks = tokens(2, 24, 1)
    patches, mpos = _image(2, 24, 1)
    tol = TOL[pair.dtype]["logits"]
    want, _ = pair.jax("forward", lambda: jit_call(
        JT.forward, pair.jcfg, pair.jp, jnp.asarray(toks),
        **_kw(patches, mpos, jnp)))
    got, aux = TT.forward(pair.tp, pair.tcfg, torch.as_tensor(toks).long(),
                          **_kw(patches, mpos, torch))
    assert tuple(got.shape) == (2, 24, pair.tcfg.vocab_padded)
    assert got.dtype == pair.tcfg.cdtype() and float(aux) == 0.0
    close(got, want, tol)
    text, _ = TT.forward(pair.tp, pair.tcfg, torch.as_tensor(toks).long())
    close(text, pair.jax("forward_text", lambda: jit_call(
        JT.forward, pair.jcfg, pair.jp, jnp.asarray(toks))[0]), tol)
    assert float((text - got).abs().max()) > 0.1   # the image counts


def _jax_prefill(pair, S, seed):
    toks = tokens(2, S, seed)
    patches, mpos = _image(2, S, seed)
    return toks, patches, mpos, pair.jax(f"prefill{S}", lambda: jit_call(
        JT.prefill, pair.jcfg, pair.jp, jnp.asarray(toks),
        **_kw(patches, mpos, jnp)))


def test_prefill_and_cache(pair):
    toks, patches, mpos, (want, jc) = _jax_prefill(pair, 20, 2)
    got, tc = TT.prefill(pair.tp, pair.tcfg, torch.as_tensor(toks).long(),
                         **_kw(patches, mpos, torch))
    assert got.dtype == torch.float32
    close(got, want, TOL[pair.dtype]["logits"])
    assert set(tc) == set(jc) == {"k", "v"}
    for key in jc:
        assert tuple(tc[key].shape) == tuple(jc[key].shape), key
        assert tc[key].dtype == getattr(torch, pair.dtype), key
        close(tc[key], jc[key], TOL[pair.dtype]["cache"], key)


def test_serve_step(pair):
    """Prefill 20 positions (the image and 4 text tokens) into a 32-row
    cache, then two decode steps, each given its token's M-RoPE
    positions."""
    toks, patches, _, (_, jpc) = _jax_prefill(pair, 20, 2)
    mpos = mrope_grid_positions(2, 22, GRID)

    def jax_steps():
        jc = JT.init_cache(pair.jcfg, 2, 32)
        jc = {k: jax.lax.dynamic_update_slice_in_dim(v, jpc[k], 0, axis=2)
              for k, v in jc.items()}
        step = jax.jit(lambda p, c, t, n, m: JT.serve_step(
            p, pair.jcfg, c, t, n, mrope_pos=m))
        out = []
        for i, tok in enumerate(([5, 300], [17, 2])):
            logits, jc = step(pair.jp, jc, jnp.asarray(tok, jnp.int32),
                              jnp.int32(20 + i),
                              jnp.asarray(mpos[:, 20 + i:21 + i]))
            out.append((logits, jc))
        return out

    want = pair.jax("serve_step", jax_steps)
    _, pc = TT.prefill(pair.tp, pair.tcfg, torch.as_tensor(toks).long(),
                       **_kw(patches, mpos[:, :20], torch))
    tc = TT.init_cache(pair.tcfg, 2, 32, device="cpu")
    t_serve.BatchServer._splice(tc, pc)
    tol = TOL[pair.dtype]
    for i, tok in enumerate(([5, 300], [17, 2])):
        got, tc = TT.serve_step(pair.tp, pair.tcfg, tc, torch.tensor(tok),
                                20 + i, mrope_pos=torch.as_tensor(
                                    mpos[:, 20 + i:21 + i]))
        jl, jc = want[i]
        assert tuple(got.shape) == (2, pair.tcfg.vocab_padded)
        close(got, jl, tol["logits"], f"step {i}")
        for key in tc:
            close(tc[key], jc[key], tol["cache"], key)


def _batch():
    b = lm_batch(2, 32, 4)
    b["patch_embeds"], b["mrope_pos"] = _image(2, 32, 4)
    return b


def test_loss_and_grads(pair):
    """The loss over an image and text and the gradient of every parameter
    against ``jax.value_and_grad``, under the model's ``"dots"`` remat."""
    assert pair.tcfg.remat_policy == "dots"
    batch = _batch()
    want_l, want_g = pair.jax("grads", lambda: jax_grads(
        JT.loss_fn, pair.jp, pair.jcfg, batch))
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
    batch = _batch()
    loss, grads = pair.jax("grads", lambda: jax_grads(
        JT.loss_fn, pair.jp, pair.jcfg, batch))
    update = jax.jit(lambda p, g: j_adamw.adamw_update(
        j_adamw.AdamWConfig(**opt), p, g, j_adamw.adamw_init(p),
        jnp.zeros((), jnp.int32))[2])
    want = {"loss": loss, **update(pair.jp, grads)}
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


def test_generate_greedy_tokens_fp32():
    """``BatchServer.generate`` serves a VLM on text (plain RoPE), as the
    JAX package's does: its greedy tokens on ragged prompts (fp32)."""
    p = Pair("float32")
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


def test_registry_batches_and_cache():
    """``batch_specs`` (patch embeddings in the compute dtype, int32 M-RoPE
    positions) and ``synth_batch`` (the JAX package's numbers for the same
    seed), and ``init_cache``."""
    jcfg, tcfg = _cfgs("bfloat16")
    fns = t_registry.get_model_fns(tcfg)
    assert fns.prefill is TT.prefill and fns.serve_step is TT.serve_step
    cache = fns.init_cache(tcfg, 2, 16, "cpu")
    jcache = JT.init_cache(jcfg, 2, 16)
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
        assert set(got) == set(want) >= {"patch_embeds", "mrope_pos"}
        for k in want:
            assert got[k].dtype == np.asarray(want[k]).dtype, k
            assert got[k].tobytes() == np.asarray(want[k]).tobytes(), k


def test_init_params_layout():
    """The port's seeded init: the JAX package's leaf count, an untied
    unembedding, and qwen2-vl-7b's published count (7.62 B)."""
    cfg = t_smoke(ARCH)
    p = TT.init_params(cfg, 0, device="cpu")
    jp = Pair("float32").jp
    assert sum(t.numel() for t in tree_leaves(p)) == sum(
        x.size for x in jax.tree.leaves(jp))
    assert tuple(p["unembed"]["w"].shape) == (256, 512)
    full = t_get(ARCH)
    assert full.param_count() == 7615483904
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.d_head, full.mrope_sections) == (28, 3584, 28, 4, 128,
                                                  (16, 24, 24))
    # the sections take dh / 2 slots between them
    cos, _ = TL.mrope_cos_sin(torch.zeros((1, 1, 3), dtype=torch.int32),
                              128, 1e6, full.mrope_sections, torch.float32)
    assert tuple(cos.shape) == (1, 1, 64)


def test_checkpoint_roundtrip_both_ways(tmp_path):
    """The smoke model's training state (an untied unembedding): a port
    checkpoint restores through ``repro.checkpoint`` into a JAX tree of the
    same structure, and a JAX checkpoint into the port's template, leaves
    equal."""
    _, tcfg = _cfgs("float32")
    state = TT.train_state(TT.init_params(tcfg, 2, device="cpu"))
    b = lm_batch(2, 24, 1)
    b["patch_embeds"], b["mrope_pos"] = _image(2, 24, 1)
    state, _ = TT.make_train_step(tcfg, t_adamw.AdamWConfig(), 1)(state, b)
    assert any("['unembed']" in k for k, _ in key_paths(state))
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
    """``launch.serve`` (text) and ``launch.train`` take the VLM's smoke
    model with ``--device cpu``; JAX unimportable."""
    out = run_launchers(launcher_cases(ARCH), tmp_path)
    rc, text = out[f"serve {ARCH}"]
    assert rc == 0 and "[serve] wave 1: [" in text
    rc, text = out[f"train {ARCH}"]
    assert rc == 0 and "[train] step     1 loss" in text


# The smoke model's bounds for chip_smoke's check, between what a sound
# decode gives here (bf16 0.0200 / 0.0031, fp32 1.6e-6 / 2.5e-7) and what
# the planted fault (decode steps given no M-RoPE positions) gives (1.02 /
# 0.154 in both dtypes), about 5x from the sound bf16 readings.
SMOKE_E2E_TOL = {"bfloat16": {"max": 0.1, "mean": 0.015},
                 "float32": {"max": 1e-3, "mean": 1e-4}}


def test_prefill_decode_matches_forward():
    """The end-to-end check ``chip_smoke.py`` makes at published widths,
    on the smoke model, in bf16 and fp32: prefill (an image and text) +
    greedy decode with M-RoPE positions against one ``forward`` over the
    same image, prompt and decoded tokens within the bounds; a decode
    given no M-RoPE positions (plain RoPE at the cache length) exceeds
    them all."""
    prompts = tokens(2, 24, 7)
    patches, _ = _image(2, 24, 7)

    def run(fault):
        out = {}
        for dtype in SMOKE_E2E_TOL:
            _, cfg = _cfgs(dtype)
            params = TT.init_params(cfg, 0, device="cpu")
            out[dtype] = chip_smoke.vlm_e2e(cfg, params, prompts, patches, 12, GRID,
                                 "cpu", fault=fault)
        return out

    good, bad = run(False), run(True)
    assert good["float32"]["positions"] == 12
    chip_smoke.check_e2e(ARCH, good, SMOKE_E2E_TOL)
    chip_smoke.check_e2e(ARCH, bad, SMOKE_E2E_TOL,
                         fault="no M-RoPE positions")
    with pytest.raises(AssertionError, match="!= forward"):
        chip_smoke.check_e2e(ARCH, bad, SMOKE_E2E_TOL)

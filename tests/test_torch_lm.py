"""The port's dense LM serving path equals the JAX package's.

``smoke_config("qwen3-0.6b")`` (4 layers, d_model 256, 4 query heads over 2
KV heads, dh 64, vocab 512) with the JAX package's own parameters
(``init_train_state(...)[0]["params"]``) handed to the port through
``params_from_reference``; token ids from a seeded numpy RNG.  Compared:
``forward`` logits, ``prefill`` logits and K/V cache, ``serve_step`` logits
and cache, ``BatchServer.generate`` tokens for ragged prompts, and a
``q_chunk`` below S so that the JAX package's chunked query scan is the
reference for the port's flash attention.

Tolerances.  In fp32 (``compute_dtype = cache_dtype = "float32"``) the two
differ only in the order of sums: logits within 1e-4 (measured 2e-6),
caches within 1e-5, greedy tokens equal.  In bf16 (the configs' default)
the two round at other places by construction (the JAX ``_sdpa`` takes
bf16 scores and casts the softmax weights to bf16, the flash path keeps
fp32 scores; XLA and PyTorch round elementwise chains differently, so an
entry near 0 computed as a difference of rounded products carries the
rounding of its operands): every entry within 2**-5 of the tensor's
largest magnitude, about 4 bf16 ulps there (measured 0.020 on logits of
magnitude up to 1.6 and 0.055 on cache entries up to 4); greedy tokens are
not compared in bf16.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.launch.serve import BatchServer as JServer  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.registry import get_model_fns as j_fns  # noqa: E402
from repro_torch.configs import get_config as t_get  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as t_fkernel  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import get_model_fns as t_fns  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
ARCH = "qwen3-0.6b"
# absolute tolerances; "scale" multiplies the reference's largest magnitude
TOL = {"float32": dict(logits=dict(atol=1e-4), cache=dict(atol=1e-5)),
       "bfloat16": dict(logits=dict(scale=2 ** -5),
                        cache=dict(scale=2 ** -5))}


class Pair:
    """One dtype: the JAX config, params and the port's counterparts."""

    def __init__(self, dtype, **kw):
        self.dtype = dtype
        self.jcfg = j_smoke(ARCH).replace(compute_dtype=dtype,
                                          cache_dtype=dtype, **kw)
        self.tcfg = t_smoke(ARCH).replace(compute_dtype=dtype,
                                          cache_dtype=dtype, **kw)
        state, _ = j_fns(self.jcfg).init_train_state(self.jcfg,
                                                     jax.random.key(0))
        self.jp = state["params"]
        self.tp = TT.params_from_reference(jax.tree.map(np.asarray, self.jp),
                                           device="cpu")


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    return Pair(request.param)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    atol = tol.get("atol", 0.0) + tol.get("scale", 0.0) * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _tokens(B, S, seed):
    return np.random.default_rng(seed).integers(0, 512, size=(B, S)).astype(
        np.int32)


def test_params_from_reference(pair):
    """Every JAX leaf arrives, unstacked per layer, bit for bit."""
    jl = pair.jp["layers"]
    assert len(pair.tp["layers"]) == pair.jcfg.n_layers
    for i, blk in enumerate(pair.tp["layers"]):
        for part, leaves in blk.items():
            for name, t in leaves.items():
                np.testing.assert_array_equal(
                    t.numpy(), np.asarray(jl[part][name][i]))
    np.testing.assert_array_equal(pair.tp["embed"]["w"].numpy(),
                                  np.asarray(pair.jp["embed"]["w"]))


def test_forward_logits(pair):
    toks = _tokens(2, 40, 1)
    want, _ = JT.forward(pair.jp, pair.jcfg, jnp.asarray(toks))
    got, aux = TT.forward(pair.tp, pair.tcfg, torch.as_tensor(toks).long())
    assert got.dtype == pair.tcfg.cdtype() and float(aux) == 0.0
    assert tuple(got.shape) == (2, 40, pair.tcfg.vocab_padded)
    _close(got, want, TOL[pair.dtype]["logits"])


def test_prefill_logits_and_cache(pair):
    toks = _tokens(3, 37, 2)
    want, jc = JT.prefill(pair.jp, pair.jcfg, jnp.asarray(toks))
    got, tc = TT.prefill(pair.tp, pair.tcfg, torch.as_tensor(toks).long())
    assert got.dtype == torch.float32
    _close(got, want, TOL[pair.dtype]["logits"])
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == tuple(jc[key].shape)
        assert str(tc[key].dtype).endswith(pair.dtype)
        _close(tc[key], jc[key], TOL[pair.dtype]["cache"])


def test_serve_step_logits_and_cache(pair):
    """Prefill 20 tokens into a 32-row cache, then two decode steps."""
    toks = _tokens(2, 20, 3)
    _, jpc = JT.prefill(pair.jp, pair.jcfg, jnp.asarray(toks))
    jc = JT.init_cache(pair.jcfg, 2, 32)
    jc = {k: jax.lax.dynamic_update_slice_in_dim(v, jpc[k], 0, axis=2)
          for k, v in jc.items()}
    _, tpc = TT.prefill(pair.tp, pair.tcfg, torch.as_tensor(toks).long())
    tc = TT.init_cache(pair.tcfg, 2, 32, device="cpu")
    for key in tc:
        tc[key][:, :, :20] = tpc[key]
    for step, tok in enumerate(([5, 300], [17, 2])):
        want, jc = JT.serve_step(pair.jp, pair.jcfg, jc,
                                 jnp.asarray(tok, jnp.int32),
                                 jnp.int32(20 + step))
        got, tc = TT.serve_step(pair.tp, pair.tcfg, tc, torch.tensor(tok),
                                20 + step)
        _close(got, want, TOL[pair.dtype]["logits"])
        for key in ("k", "v"):
            _close(tc[key], jc[key], TOL[pair.dtype]["cache"])


def test_generate_ragged_prompts():
    """Greedy tokens for ragged prompts (padded at the end, the first new
    token of a shorter prompt taken at a pad position), fp32."""
    p = Pair("float32")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 512, size=n).astype(np.int32)
               for n in (5, 12, 9)]
    want = JServer(p.jcfg, p.jp, batch=4, max_seq=32).generate(prompts,
                                                              max_new=12)
    got = t_serve.BatchServer(p.tcfg, p.tp, batch=4, max_seq=32,
                              device="cpu").generate(prompts, max_new=12)
    assert [len(g) for g in got] == [len(w) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_generate_stops_at_max_seq_and_eos():
    p = Pair("float32")
    prompts = [np.arange(1, 9, dtype=np.int32)]
    want = JServer(p.jcfg, p.jp, batch=2, max_seq=12).generate(prompts,
                                                              max_new=10)
    server = t_serve.BatchServer(p.tcfg, p.tp, batch=2, max_seq=12,
                                 device="cpu")
    got = server.generate(prompts, max_new=10)
    np.testing.assert_array_equal(got[0], want[0])
    eos = int(got[0][9])                   # the second new token
    stopped = server.generate(prompts, max_new=10, eos_id=eos)
    want_eos = JServer(p.jcfg, p.jp, batch=2, max_seq=12).generate(
        prompts, max_new=10, eos_id=eos)
    np.testing.assert_array_equal(stopped[0], want_eos[0])


def test_q_chunk_scan_is_the_reference():
    """With q_chunk 16 below S 48 the JAX package runs its chunked query
    scan; the port's flash attention replaces it (fp32)."""
    p = Pair("float32", q_chunk=16)
    toks = _tokens(2, 48, 5)
    want, _ = JT.forward(p.jp, p.jcfg, jnp.asarray(toks))
    got, _ = TT.forward(p.tp, p.tcfg, torch.as_tensor(toks).long())
    _close(got, want, TOL["float32"]["logits"])
    want, jc = JT.prefill(p.jp, p.jcfg, jnp.asarray(toks))
    got, tc = TT.prefill(p.tp, p.tcfg, torch.as_tensor(toks).long())
    _close(got, want, TOL["float32"]["logits"])
    _close(tc["k"], jc["k"], TOL["float32"]["cache"])


def test_prefill_runs_attention_through_the_kernel_wrapper(monkeypatch):
    """Every layer's prefill attention goes through flash_attention_gqa
    (one call per layer); decode does not."""
    p = Pair("float32")
    calls = []
    real = t_fkernel.flash_attention_plain
    monkeypatch.setattr(t_fkernel, "flash_attention_plain",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    _, cache = TT.prefill(p.tp, p.tcfg, torch.as_tensor(_tokens(1, 9, 6))
                          .long())
    assert len(calls) == p.tcfg.n_layers
    big = TT.init_cache(p.tcfg, 1, 16, device="cpu")
    TT.serve_step(p.tp, p.tcfg, big, torch.tensor([3]), 9)
    assert len(calls) == p.tcfg.n_layers


def test_init_params_scales():
    """The JAX package's init scales, from a seeded torch.Generator."""
    cfg = t_smoke(ARCH)
    a = TT.init_params(cfg, 3, device="cpu")
    b = TT.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    np.testing.assert_array_equal(a["embed"]["w"].numpy(),
                                  b["embed"]["w"].numpy())
    assert "unembed" not in a                           # tied embeddings
    assert abs(float(a["embed"]["w"].std()) - 0.02) < 1e-3
    attn = a["layers"][0]["attn"]
    D, H, dh = cfg.d_model, cfg.n_heads, cfg.d_head
    assert abs(float(attn["wq"].std()) * D ** 0.5 - 1) < 0.05
    assert abs(float(attn["wo"].std()) * (H * dh) ** 0.5 - 1) < 0.05
    assert float(attn["q_norm"].min()) == float(attn["q_norm"].max()) == 1
    assert all(t.dtype == torch.float32 for t in attn.values())
    assert cfg.vocab_padded == 512
    full = t_get(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.d_head, full.vocab_padded) == (28, 1024, 16, 8, 128, 152064)
    assert full.param_count() == 596172800


def test_entry_points_default_to_the_card(monkeypatch):
    cfg = t_smoke(ARCH)
    params = TT.init_params(cfg, 0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (lambda: TT.init_params(cfg),
               lambda: TT.init_cache(cfg, 1, 8),
               lambda: TT.params_from_reference({"layers": {}}),
               lambda: t_serve.BatchServer(cfg, params),
               lambda: t_serve.main(["--arch", ARCH + "-smoke"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


def test_other_families_are_not_ported():
    for arch in ("mamba2-780m", "deepseek-v2-lite-16b", "whisper-base"):
        with pytest.raises(NotImplementedError, match="item 9"):
            t_fns(t_smoke(arch))


def test_serve_launcher_cpu_without_jax():
    """The launcher serves on the CPU and the port imports no JAX."""
    code = (
        "import sys\n"
        "from repro_torch.launch import serve\n"
        "from repro_torch import models, configs\n"
        "from repro_torch.kernels import flash_attention\n"
        "assert serve.main(['--device', 'cpu', '--arch', "
        "'qwen3-0.6b-smoke', '--requests', '3', '--batch', '2', "
        "'--max-new', '5']) == 0\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "[serve] wave 1: [" in out.stdout
    assert out.stdout.strip().endswith("clean")


def test_prefill_decode_matches_forward_bf16(monkeypatch):
    """The end-to-end check ``chip_smoke.py`` makes at full width, on the
    smoke model: the logits of prefill + decode (plain ``_sdpa`` over the
    bf16 cache) equal those of one ``forward`` (flash attention) over the
    same tokens within its bf16 tolerance, and a wrong GQA head mapping in
    the flash path (head h on KV head h % KV) breaks it."""
    from repro_torch.kernels.flash_attention import ref as t_ref
    from repro_torch.models import layers as TL
    monkeypatch.syspath_prepend(os.path.dirname(SRC))
    import chip_smoke

    cfg = t_smoke(ARCH)
    params = TT.init_params(cfg, 0, device="cpu")
    server = t_serve.BatchServer(cfg, params, batch=2, max_seq=64,
                                 device="cpu")
    seen = []
    prefill, step = server._prefill, server._step
    server._prefill = lambda *a: (lambda r: seen.append(r[0]) or r)(
        prefill(*a))
    server._step = lambda *a: (lambda r: seen.append(r[0]) or r)(step(*a))
    prompts = [_tokens(1, 24, 7)[0], _tokens(1, 24, 8)[0]]
    outs = server.generate(prompts, max_new=8)
    seq = torch.as_tensor(np.stack(outs)).long()
    dec = torch.stack(seen, dim=1)

    def diff():
        full, _ = TT.forward(params, cfg, seq)
        d = (dec - full[:, 23:23 + dec.shape[1]].float()).abs()
        return float(d.max()), float(d.mean())

    dmax, dmean = diff()
    assert dmax <= chip_smoke.LM_E2E_MAX_TOL
    assert dmean <= chip_smoke.LM_E2E_MEAN_TOL

    def wrong_heads(q, k, v, causal=True, device=None):
        G = q.shape[2] // k.shape[2]
        return t_ref.ref_attention_gqa(q, k.repeat(1, 1, G, 1),
                                       v.repeat(1, 1, G, 1), causal=causal)

    monkeypatch.setattr(TL, "flash_attention", wrong_heads)
    bmax, bmean = diff()
    assert bmax > chip_smoke.LM_E2E_MAX_TOL
    assert bmean > chip_smoke.LM_E2E_MEAN_TOL

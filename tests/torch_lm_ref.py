"""Shared by the LM substrate's parity tests: the whole-model files
(``tests/test_torch_lm_moe.py``, ``_ssm``, ``_encdec``, ``_vlm``) take the
JAX package's parameters and results, each computed once per module and
jitted, the comparisons with their tolerances, and the port's launchers
run in one subprocess with JAX unimportable; every LM file takes
:func:`one_torch_thread`.

JAX results are jitted (a fresh function for each call, so no trace made
under one monkeypatch is reused under another): eager JAX compiles each
scan body and each small op on its own and took most of these files' time.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import registry as j_registry
from repro_torch.tree import key_paths, tree_leaves, tree_unflatten

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
STACKS = ("layers", "enc_layers")

_MEMO = {}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread for the module (a test module that imports
    this fixture uses it).  The suite runs several pytest workers on the
    machine's cores, and torch's default of one OpenMP thread per core in
    each worker spins them against each other: six LM files side by side
    took 735 s on 8 cores, at one thread each 123 s; alone, the MoE and SSM
    files took 173 s at 8 threads and 151 s at one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def memo(key, fn):
    """``fn()``, once per key for the life of the test process."""
    if key not in _MEMO:
        _MEMO[key] = fn()
    return _MEMO[key]


def jax_params(jcfg, key):
    """The JAX package's own parameters (``init_train_state``, seed 0) for
    ``jcfg``, once per ``key`` (parameters are fp32 whatever the compute
    dtype, so one set serves both dtypes)."""
    def init():
        state, _ = j_registry.get_model_fns(jcfg).init_train_state(
            jcfg, jax.random.key(0))
        return state["params"]
    return memo(("params", key), init)


def jit_call(fn, jcfg, *args, **kw):
    """``fn(args[0], jcfg, *args[1:], **kw)`` jitted, ``jcfg`` static."""
    return jax.jit(lambda *a, **k: fn(a[0], jcfg, *a[1:], **k))(*args, **kw)


def np_(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def close(got, want, tol, msg="", want32=None):
    """|got - want| within tol (``atol``, or ``scale`` x want's largest
    magnitude); in bf16 (``want32`` the JAX package's fp32 result) or
    |got - want32| within the larger of that and twice |want - want32|."""
    got, want = np_(got), np_(want)
    assert got.shape == want.shape, msg
    atol = tol.get("atol", 0.0) + tol.get("scale", 0.0) * np.abs(want).max()
    if want32 is not None and np.abs(got - want).max() > atol:
        want32 = np_(want32)
        atol = max(atol, 2 * float(np.abs(want - want32).max()))
        want = want32
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=msg)


def scalar_close(got, want, limit, want32=None, relative=False):
    """A scalar within ``limit`` (absolute, or relative to want) of want;
    in bf16 or of the fp32 value ``want32`` within the larger of that and
    twice the JAX package's own distance from it."""
    err = lambda a, b: abs(a / b - 1) if relative else abs(a - b)
    got, want = float(got), float(want)
    if want32 is not None and err(got, want) > limit:
        limit = max(limit, 2 * err(want, float(want32)))
        want = float(want32)
    assert err(got, want) <= limit, (got, want, limit)


def tokens(B, S, seed, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S)) \
        .astype(np.int32)


def lm_batch(B, S, seed):
    toks = tokens(B, S, seed)
    targets = np.concatenate([toks[:, 1:], np.full((B, 1), -1, np.int32)],
                             axis=1)
    targets[0, 3] = -1
    return {"tokens": toks, "targets": targets}


def flat(jax_tree):
    """{key path: numpy leaf} of a JAX tree, once per tree."""
    return memo(("flat", id(jax_tree)), lambda: (jax_tree, dict(
        key_paths(jax.tree.map(np.asarray, jax_tree)))))[1]


def port_key(jax_tree, key):
    """The JAX leaf (``layers`` and ``enc_layers`` stacked) that the port's
    key path names."""
    leaves = flat(jax_tree)
    for name in STACKS:
        head = f"['{name}']["
        if key.startswith(head):
            i, rest = key[len(head):].split("]", 1)
            return leaves[f"['{name}']" + rest][int(i)]
    return leaves[key]


def n_port_leaves(jax_tree):
    """How many leaves the port's tree has for this JAX tree: each stacked
    leaf once a layer."""
    n = 0
    for key, leaf in flat(jax_tree).items():
        stacked = any(key.startswith(f"['{s}']") for s in STACKS)
        n += leaf.shape[0] if stacked else 1
    return n


def port_grads(loss_fn, tparams, tcfg, batch):
    """The port's loss and gradients (a tree like ``tparams``)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(tparams)]
    loss = loss_fn(tree_unflatten(tparams, leaves), tcfg,
                   {k: torch.as_tensor(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(tparams, list(grads))


def jax_grads(loss_fn, jparams, jcfg, batch):
    """The JAX package's loss and gradients (jitted: one compile)."""
    fn = jax.jit(jax.value_and_grad(lambda p, b: loss_fn(p, jcfg, b)))
    return fn(jparams, jax.tree.map(jnp.asarray, batch))


def run_launchers(cases, tmp_path):
    """Run the port's launchers in one subprocess with ``jax`` and
    ``repro`` unimportable: ``cases`` {name: (module, argv)} -> {name:
    (exit code, stdout)}.  Each ``main(argv)`` runs in turn; stdout is
    captured per case."""
    code = (
        "import contextlib, importlib, io, json, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"cases = {cases!r}\n"
        "out = {}\n"
        "for name, (module, argv) in cases.items():\n"
        "    buf = io.StringIO()\n"
        "    with contextlib.redirect_stdout(buf):\n"
        "        rc = importlib.import_module(module).main(argv)\n"
        "    out[name] = (rc, buf.getvalue())\n"
        "print('RESULT ' + json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=SRC, TMPDIR=str(tmp_path),
               OMP_NUM_THREADS="1")     # as one_torch_thread
    run = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr
    line = [x for x in run.stdout.splitlines() if x.startswith("RESULT ")]
    return {k: tuple(v) for k, v in json.loads(line[-1][7:]).items()}


def launcher_cases(arch):
    """``launch.serve`` (3 requests, batch 2, 4 new tokens) and
    ``launch.train`` (2 steps of 2 x 32 tokens) on ``arch``'s smoke model
    with ``--device cpu``."""
    smoke = ["--device", "cpu", "--arch", arch + "-smoke"]
    return {f"train {arch}": ("repro_torch.launch.train", smoke + [
                "--steps", "2", "--seq", "32", "--global-batch", "2",
                "--log-every", "1"]),
            f"serve {arch}": ("repro_torch.launch.serve", smoke + [
                "--requests", "3", "--batch", "2", "--max-new", "4"])}

"""Checkpointing: atomic, keep-k, async, restore into a template (the JAX
package's ``checkpoint/manager.py``, on nested dicts and lists of tensors).

Layout, the JAX package's:
    <dir>/step_<N>/manifest.json       key paths, shapes, dtypes, metadata
    <dir>/step_<N>/arrays.npz          one entry per leaf (host numpy)
    <dir>/LATEST                       text file with the newest step

Leaves are keyed by their path in ``jax.tree_util.keystr``'s format
(``repro_torch.tree.key_paths``; the ``layers`` list puts its index in the
path), so either package restores what the other wrote into a tree of the
same structure.  numpy has no bfloat16: a bf16 leaf is stored as float32,
which holds it exactly, and restore casts back to the template's dtype.

Writes go to ``step_<N>.tmp`` and are renamed into place (atomic on POSIX),
so a crash mid-write never corrupts the latest checkpoint.  Restore takes a
*template* tree and puts each leaf on the template leaf's device and dtype:
the manifest stores logical shapes only.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import key_paths, tree_unflatten


def _host(leaf, copy: bool = False) -> np.ndarray:
    """A leaf as a host array; ``copy`` makes it the array's own memory
    (a CPU tensor's ``numpy()`` shares the tensor's)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=copy).numpy()
    return np.array(leaf) if copy else np.asarray(leaf)


def save(directory: str, step: int, state: Any, *, keep: int = 3,
         extra_meta: Optional[dict] = None) -> str:
    """Blocking atomic save. Returns the final checkpoint path."""
    return _write(directory, step, {k: _host(v) for k, v in key_paths(state)},
                  keep, extra_meta)


def _write(directory: str, step: int, host: dict, keep: int,
           extra_meta: Optional[dict]) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    np.savez(os.path.join(tmp, "arrays.npz"), **host)
    manifest = {
        "step": step,
        "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                   for k, v in host.items()},
        "meta": extra_meta or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    with open(os.path.join(directory, "LATEST.tmp"), "w") as f:
        f.write(str(step))
    os.replace(os.path.join(directory, "LATEST.tmp"),
               os.path.join(directory, "LATEST"))
    _cleanup(directory, keep)
    return final


def _cleanup(directory: str, keep: int) -> None:
    steps = sorted(all_steps(directory))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


def all_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append(int(name[len("step_"):]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    path = os.path.join(directory, "LATEST")
    if os.path.exists(path):
        with open(path) as f:
            s = int(f.read().strip())
        if os.path.isdir(os.path.join(directory, f"step_{s:08d}")):
            return s
    steps = all_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, template: Any, *,
            step: Optional[int] = None) -> tuple[Any, int]:
    """Restore into the structure of ``template`` (a tree of tensors) ->
    (state, step); each leaf takes its template leaf's device and dtype."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    leaves = []
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        names = set(npz.files)
        for key, leaf in key_paths(template):
            if key not in names:
                raise KeyError(f"checkpoint {path} missing leaf {key}")
            arr = npz[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                                 f"template {tuple(leaf.shape)}")
            leaves.append(torch.from_numpy(arr).to(device=leaf.device,
                                                   dtype=leaf.dtype))
    return tree_unflatten(template, leaves), step


class AsyncCheckpointer:
    """Background writer: snapshot to host, save on a thread, never blocks
    the step loop for longer than the device->host copy.

    :meth:`save` returns only once every leaf has its own host copy: the
    next optimizer step updates the state's tensors in place."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, state: Any, extra_meta: Optional[dict] = None):
        self.wait()
        host = {k: _host(v, copy=True) for k, v in key_paths(state)}

        def work():
            try:
                _write(self.directory, step, host, self.keep, extra_meta)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

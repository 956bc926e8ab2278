"""Variants of a kernel library made by text substitution, timed on the card.

A variant copies every source of a :class:`~repro_torch.kernels.build.Library`
into its own directory under the library's ``build/variants/``, replaces
exact strings in one of them and builds as the library does.  A kernel
package's variants tool (``kernels/wfa/meet_variants.py``,
``kernels/flash_attention/variants.py``) keeps only its table of
substitutions and its inputs; this module builds the variants, swaps each
into the package's ``build.load`` in turn, reads ptxas's report and times
with CUDA events.
"""
from __future__ import annotations

import contextlib
import os
import re
import subprocess

from repro_torch.kernels import build as kbuild


def edited_library(lib: kbuild.Library, tag: str, source: str,
                   subs) -> kbuild.Library:
    """A copy of ``lib`` named ``tag`` whose ``source`` has each ``(old,
    new)`` of ``subs`` applied; an ``old`` missing from it raises."""
    pkg = os.path.join(lib.build_dir(), "variants", tag)
    os.makedirs(os.path.join(pkg, "csrc"), exist_ok=True)
    names = [os.path.basename(s) for s in lib.sources]
    if source not in names:
        raise ValueError(f"{source} is not a source of {lib.name}")
    for src, name in zip(lib.sources, names):
        with open(src) as f:
            text = f.read()
        if name == source:
            for old, new in subs:
                if old not in text:
                    raise ValueError(f"variant {tag}: {old!r} is not in "
                                     f"{source}")
                text = text.replace(old, new)
        with open(os.path.join(pkg, "csrc", name), "w") as f:
            f.write(text)
    return kbuild.Library(f"{lib.name}_{tag}", pkg, names, lib._declare)


def ptxas_entry(log: str, entry: str) -> dict:
    """Registers and spill-store bytes ptxas reported for the first entry
    function whose mangled name matches the regex ``entry``."""
    m = re.search(rf"Compiling entry function '\w*{entry}\w*'"
                  r".*?(\d+) bytes spill stores.*?Used (\d+) registers",
                  log, re.S)
    if m is None:
        raise ValueError(f"no ptxas report of an entry matching {entry!r}")
    return dict(registers=int(m.group(2)), spill_bytes=int(m.group(1)))


def cuda_ms(fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` over ``reps`` calls after one warm
    call, by CUDA events on the current stream."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def loaded_from(build_module, lib: kbuild.Library):
    """Within the block, ``build_module.load`` (which the package's
    wrappers call at each launch) loads ``lib``."""
    load = build_module.load
    build_module.load = lib.load
    try:
        yield
    finally:
        build_module.load = load


def build_variants(lib: kbuild.Library, source: str, table: dict) -> dict:
    """``{name: (checked, subs)}`` -> ``{name: Library}``, all built
    together (one nvcc per source of every variant, started at once)."""
    libs = {name: edited_library(lib, name, source, subs)
            for name, (_, subs) in table.items()}
    kbuild.build_all(list(libs.values()))
    for v in libs.values():
        v.load()
    return libs


def time_in_turns(libs: dict, build_module, runs: dict, reps: int,
                  turns: int = 3) -> dict:
    """Time every ``runs`` entry (name -> callable) under each variant in
    ``turns`` turns (in order, reversed, in order, ...) -> ``{variant:
    {run: [ms per turn]}}``."""
    out = {name: {run: [] for run in runs} for name in libs}
    order = list(libs)
    for turn in (order if i % 2 == 0 else order[::-1]
                 for i in range(turns)):
        for name in turn:
            with loaded_from(build_module, libs[name]):
                for run, fn in runs.items():
                    out[name][run].append(cuda_ms(fn, reps))
    return out


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()

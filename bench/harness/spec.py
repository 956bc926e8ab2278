"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<name>`` is ``bench/workloads/<name>.json`` (its traffic and
loop), a configuration is the ``file`` its entry names, and a per-layer
metric ``<name>`` is the reader ``bench/metrics/<name>.py``.  Adding any
of them is adding a file and an entry; nothing here lists them.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES_E2E = ("host_clock", "device_trace")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(spec: dict, name: str, root: str = ROOT) -> dict:
    """-> {"entry", "workload", "config_entry", "config"} of cell ``name``
    (``KeyError`` if ``BENCHMARK.json`` has no such cell)."""
    entry = {w["name"]: w for w in spec["workloads"]}[name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[entry["config"]]
    return {"entry": entry,
            "workload": _read_json(os.path.join(root, "bench", "workloads",
                                                f"{name}.json")),
            "config_entry": cfg_entry,
            "config": _read_json(os.path.join(root, cfg_entry["file"]))}


def _applies(metric: dict, name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def end_to_end(spec: dict, name: str) -> List[dict]:
    return [m for m in spec["end_to_end"] if _applies(m, name)]


def per_layer(spec: dict, name: str) -> List[dict]:
    """Per-layer metrics of cell ``name``: those listing it, and those
    without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end(spec, name)}
    return [m for m in spec["per_layer"]
            if name in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in e2e)]


def reader(name: str, root: str = ROOT) -> Callable:
    """The ``read(run)`` of ``bench/metrics/<name>.py``."""
    path = os.path.join(root, "bench", "metrics", f"{name}.py")
    mod_spec = importlib.util.spec_from_file_location(
        "bench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def problems(spec: dict, root: str = ROOT) -> List[str]:
    """What in ``spec`` breaks the benchmark's rules of names and files
    (empty when none)."""
    out: List[str] = []

    def name_ok(what: str, v: Optional[str]) -> None:
        if not isinstance(v, str) or not NAME_RE.match(v):
            out.append(f"{what}: bad name {v!r}")

    def text_ok(what: str, v) -> None:
        if not (isinstance(v, str) and 1 <= len(v) <= 200
                and "\n" not in v and "\t" not in v):
            out.append(f"{what}: bad text {v!r}")

    names: Dict[str, set] = {"configs": set(), "workloads": set(),
                             "metrics": set()}
    for c in spec["configs"]:
        name_ok("config", c["name"])
        text_ok(f"config {c['name']} source", c["source"])
        text_ok(f"config {c['name']} why", c["why"])
        for k in c["reduced"]:
            name_ok(f"config {c['name']} reduced", k)
        if not os.path.isfile(os.path.join(root, c["file"])):
            out.append(f"config {c['name']}: no file {c['file']}")
        names["configs"].add(c["name"])
    for w in spec["workloads"]:
        for key in ("name", "config", "traffic"):
            name_ok(f"workload {w['name']} {key}", w[key])
        text_ok(f"workload {w['name']} why", w["why"])
        if w["config"] not in names["configs"]:
            out.append(f"workload {w['name']}: no config {w['config']}")
        path = os.path.join(root, "bench", "workloads", f"{w['name']}.json")
        if not os.path.isfile(path):
            out.append(f"workload {w['name']}: no file {path}")
        names["workloads"].add(w["name"])
    for kind in ("end_to_end", "per_layer"):
        for m in spec[kind]:
            name_ok(f"{kind} metric", m["name"])
            if not isinstance(m["unit"], str) or not UNIT_RE.match(m["unit"]):
                out.append(f"metric {m['name']}: bad unit {m['unit']!r}")
            if m["better"] not in ("lower", "higher"):
                out.append(f"metric {m['name']}: better {m['better']!r}")
            allowed = SOURCES_E2E if kind == "end_to_end" else SOURCES
            if m["source"] not in allowed:
                out.append(f"metric {m['name']}: source {m['source']!r}")
            for w in m.get("workloads", ()):
                if w not in names["workloads"]:
                    out.append(f"metric {m['name']}: no cell {w}")
            if m["name"] in names["metrics"]:
                out.append(f"metric {m['name']}: named twice")
            names["metrics"].add(m["name"])
    for m in spec["per_layer"]:
        text_ok(f"metric {m['name']} layer", m["layer"])
        for w in m.get("workloads", ()):
            if w in names["workloads"] and m["moves"] not in {
                    e["name"] for e in end_to_end(spec, w)}:
                out.append(f"metric {m['name']}: cell {w} does not report "
                           f"{m['moves']}")
        if not os.path.isfile(os.path.join(root, "bench", "metrics",
                                           f"{m['name']}.py")):
            out.append(f"metric {m['name']}: no reader")
    return out

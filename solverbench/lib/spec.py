"""``BENCHMARK.json`` and the files it names, found by name.

A workload ``<config>.<mix>`` runs ``configs/<config>.json`` under
``traffic/<mix>.json``.  Each name in those files is a file of its own,
``<kind>/<name>.py`` (``plugin``):

- the configuration's ``operator.kind`` → ``operators/<kind>.py``
  (``build(op)``), its ``operator.order`` → ``orders/<order>.py``
  (``apply(A)``);
- its ``solver.route`` → ``solvers/<route>.py`` (``Route``), its
  ``solver.operand`` → ``operands/<operand>.py`` (``make``);
- its ``check`` → ``reference/<check>.py`` (``judge``);
- the mix's ``variation`` → ``variations/<variation>.py``
  (``Variation``);
- every metric, end to end or per layer → ``metrics/<metric>.py``
  (``read(run)``);
- the SpMV kernels the roofline reader knows → ``kernels/*.json``.

A new cell, mix, route, operator, metric or kernel is new files and new
entries in ``BENCHMARK.json``: nothing here names one.
"""
from __future__ import annotations

import glob
import importlib.util
import json
import os
import sys
from typing import Callable, Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_spec(path: str = None) -> dict:
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                   f"{[w['name'] for w in spec['workloads']]})")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def config(spec: dict, name: str) -> dict:
    """The configuration's file, as ``BENCHMARK.json`` names it."""
    for c in spec["configs"]:
        if c["name"] == name:
            return _json(os.path.join(ROOT, c["file"]))
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def mix(name: str) -> dict:
    return _json(os.path.join(BENCH_DIR, "traffic", f"{name}.json"))


def plugin(kind: str, name: str):
    """The module of ``<kind>/<name>.py`` under the benchmark's folder,
    loaded from its file (names may hold dots)."""
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise KeyError(f"no {kind}/{name}.py in {BENCH_DIR}")
    mod_name = "solverbench_" + "".join(
        c if c.isalnum() else "_" for c in f"{kind}_{name}")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def build_operator(op: dict):
    """The benchmark's CSR that a configuration's ``operator`` entry
    describes, in the order it names (default "natural")."""
    A = plugin("operators", op["kind"]).build(op)
    return plugin("orders", op.get("order", "natural")).apply(A)


def kernels() -> List[dict]:
    """Every entry of ``kernels/*.json``: a kernel name's substring and the
    storage format whose product it computes."""
    return [_json(p) for p in sorted(glob.glob(
        os.path.join(BENCH_DIR, "kernels", "*.json")))]


def metric_reader(name: str) -> Callable:
    """``read(run)`` of ``metrics/<name>.py``."""
    return plugin("metrics", name).read


def cell_metrics(spec: dict, cell: str, kind: str) -> List[dict]:
    """The metrics of ``kind`` ("end_to_end" or "per_layer") that the cell
    reports: those without ``workloads`` and those that list it."""
    return [m for m in spec[kind] if cell in m.get("workloads", [cell])]


def read_metrics(spec: dict, cell: str, kind: str, run) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of the cell's metrics of ``kind``; a
    reader that finds nothing to read returns None and its metric is left
    out."""
    out = {}
    for m in cell_metrics(spec, cell, kind):
        value = metric_reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out

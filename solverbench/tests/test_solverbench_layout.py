"""The harness finds every configuration, mix and metric of
BENCHMARK.json by name, and nothing it runs loads JAX or the JAX
package."""
import ast
import json
import os
import re

import pytest

from solverbench.lib import spec as S

SPEC = S.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_finds_its_files(cell):
    w = S.workload(SPEC, cell)
    assert cell == f"{w['config']}.{w['traffic']}"
    cfg = S.config(SPEC, w["config"])
    assert cfg["name"] == w["config"]
    mix = S.mix(w["traffic"])
    # every name in the configuration and the mix is a file of its own
    assert callable(S.plugin("operators", cfg["operator"]["kind"]).build)
    assert callable(S.plugin("orders", cfg["operator"]["order"]).apply)
    assert callable(S.plugin("solvers", cfg["solver"]["route"]).Route)
    assert callable(S.plugin("operands", cfg["solver"]["operand"]).make)
    assert callable(S.plugin("reference", cfg["check"]).judge)
    assert callable(S.plugin("variations", mix["variation"]).Variation)
    e2e = [m["name"] for m in S.cell_metrics(SPEC, cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = S.cell_metrics(SPEC, cell, "per_layer")
    assert per_layer
    for m in per_layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["end_to_end"]
                                    + SPEC["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(S.metric_reader(metric))


def test_the_spec_keeps_its_shape_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert c["file"].startswith("solverbench/configs/")
        cfg = S.config(SPEC, c["name"])
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    assert all(e["bound"] <= 0.25 for e in SPEC["end_to_end"])
    with pytest.raises(KeyError):
        S.workload(SPEC, "no_such.cell")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            yield "." * node.level + (node.module or "")


def _sources(sub=""):
    root = os.path.join(S.BENCH_DIR, sub)
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


FORBIDDEN = {"jax", "jaxlib", "flax", "pysolvers_tpu", "benchmarks",
             "bench", "chip_smoke"}


def test_nothing_imports_jax_or_the_jax_package():
    """By whole top-level name: the program's own name begins with the JAX
    package's."""
    for path in _sources():
        bad = set(_imports(path)) & FORBIDDEN
        assert not bad, f"{path} imports {bad}"
    assert "pysolvers_tpu" not in {"pysolvers_tpu_torch".split(".")[0]}


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        assert set(_imports(path)) <= {"__future__", "numpy"}, path


def test_run_refuses_forbidden_modules(monkeypatch):
    import sys
    from solverbench import run
    for name in list(sys.modules):
        if name.split(".")[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "pysolvers_tpu_torch_probe", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    monkeypatch.setitem(sys.modules, "pysolvers_tpu.ops", object())
    assert run.forbidden_modules() == ["jaxlib", "pysolvers_tpu"]


NEW_FILES = {
    # a new operator built on an existing one, a new variation, a new
    # mix, a new configuration and a new metric: files only
    "solverbench/operators/fd5_scaled.py": """
from solverbench.lib import spec as S


def build(op):
    A = S.plugin("operators", "fd5_laplacian_2d").build(op)
    return A.with_data(A.data * op["scale"])
""",
    "solverbench/variations/diag_shift.py": """
class Variation:
    frozen = False

    def __init__(self, mix, A, A_dev, uniform):
        self.mix, self.A, self.A_dev = mix, A, A_dev
        self.pos = A.diag_positions()

    def next(self):
        return self.mix["shift"]

    def matvec(self, shift, x):
        return self.A_dev @ x + shift * x

    def host(self, shift):
        data = self.A.data.copy()
        data[self.pos] += shift
        return self.A.with_data(data)
""",
    "solverbench/traffic/shifted.json": json.dumps({
        "variation": "diag_shift", "shift": 3.0, "warmup_solves": 1,
        "check_every": 1, "trace_min_seconds": 0.5}),
    "solverbench/configs/fd5_scaled_small.json": None,   # made below
    "solverbench/metrics/krylov.iters_max.py": """
def read(run):
    return max((s["iters"] for s in run.solves), default=None)
""",
}


def test_a_new_cell_is_new_files_only(tmp_path, monkeypatch):
    """A copy of the benchmark gains a cell with a new operator, variation,
    mix, configuration and metric by adding files and entries alone; it
    runs, and every file the copy had is unchanged."""
    import hashlib
    import shutil
    import time

    from solverbench.lib import loop
    root = tmp_path / "checkout"
    shutil.copytree(S.BENCH_DIR, root / "solverbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(S.ROOT, "BENCHMARK.json"), root)

    def digests():
        return {p: hashlib.sha256(p.read_bytes()).hexdigest()
                for p in root.rglob("*") if p.is_file()
                and "__pycache__" not in p.parts}
    before = digests()
    cfg = json.loads(open(os.path.join(
        S.BENCH_DIR, "configs", "fd5_poisson_1M.json")).read())
    cfg.update(name="fd5_scaled_small",
               operator={"kind": "fd5_scaled", "m": 15, "scale": 0.5,
                         "order": "natural"})
    files = dict(NEW_FILES)
    files["solverbench/configs/fd5_scaled_small.json"] = json.dumps(cfg)
    for rel, text in files.items():
        path = root / rel
        assert not path.exists(), rel
        path.write_text(text)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(
        name="fd5_scaled_small", source=cfg["source"],
        file="solverbench/configs/fd5_scaled_small.json", reduced=[],
        why="a test"))
    cell = "fd5_scaled_small.shifted"
    spec["workloads"].append(dict(name=cell, config="fd5_scaled_small",
                                  traffic="shifted", chips=1, why="a test"))
    spec["per_layer"].append(dict(
        name="krylov.iters_max", unit="iters", better="lower",
        source="program_counter", layer="krylov loop", moves="setup_s",
        workloads=[cell]))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    monkeypatch.setattr(S, "BENCH_DIR", str(root / "solverbench"))
    monkeypatch.setattr(S, "ROOT", str(root))
    spec = S.load_spec()
    w = S.workload(spec, cell)
    run = loop.run_cell(S.config(spec, w["config"]), S.mix(w["traffic"]),
                        2**31 + 99, 0.3, False, "cpu", time.perf_counter())
    assert run.correct, run.checks
    assert not run.mix.get("columns") and run.failed == 0
    got = S.read_metrics(spec, cell, "per_layer", run)
    assert got["krylov.iters_max"]["value"] >= 1
    after = digests()
    spec_file = root / "BENCHMARK.json"    # which gains the entries
    assert {p: d for p, d in after.items() if p in before
            and p != spec_file} == {p: d for p, d in before.items()
                                    if p != spec_file}
    assert len(after) == len(before) + len(files)

"""The port never imports jax or pysolvers_tpu, and neither does
chip_smoke.py.  Checked on the source (AST), because this environment's
interpreter may import jax at start-up, which a sys.modules check would
confuse with an import by the port."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "pysolvers_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "pysolvers_tpu")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_package():
    assert len(FILES) > 15
    for rel in ("ops/spmv.py", "ops/bws_spmv.py", "ops/probe.py",
                "sparse/bws.py", "problems/fem.py", "sparse/bdia.py",
                "linear/block_precond.py", "ops/grid_spmv.py",
                "linear/gmg.py", "linear/gmg_grid.py", "linear/amg_rs.py",
                "linear/ilu.py", "linear/arnoldi.py", "linear/operator.py",
                "linear/refine.py", "ops/block_trisolve.py"):
        assert ROOT / "pysolvers_tpu_torch" / rel in FILES

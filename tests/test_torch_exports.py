"""The port's public names against the JAX package's: every name of
``pysolvers_tpu.__all__`` is in ``pysolvers_tpu_torch.__all__`` except the
three still to port or not to port (``read_mtx``, ``write_mtx``: ROADMAP
queue 1; ``prime_cache``: a TPU workaround), and the Newton slice's
modules export what the JAX package's do."""
import pytest

import pysolvers_tpu as pst
import pysolvers_tpu_torch as pt
from pysolvers_tpu import nonlinear as jnl
from pysolvers_tpu import problems as jprob

MISSING = {"read_mtx", "write_mtx", "prime_cache"}


def test_all_but_three_jax_names():
    assert set(pst.__all__) - set(pt.__all__) == MISSING


@pytest.mark.parametrize("name", sorted(set(pt.__all__)))
def test_exported_name_exists(name):
    assert getattr(pt, name) is not None


def test_nonlinear_and_problems_exports():
    assert set(pt.nonlinear.__all__) == set(jnl.__all__)
    for name in jnl.__all__:
        assert hasattr(pt.nonlinear, name)
    assert hasattr(jprob, "Bratu2D") and hasattr(jprob.bratu,
                                                 "Bratu2DHostOuter")
    assert {"Bratu2D", "Bratu2DHostOuter"} <= set(pt.problems.__all__)
    assert {"cg_solve_multi", "gmres_solve_multi"} <= set(pt.linear.__all__)

"""K7 (``ops/probe.py``) on the CPU against the JAX probe.

The TPU probe is ``benchmarks/probe_idx16.py``: a Pallas kernel that loads
int16 lane indices, widens them to int32 and gathers along 128 lanes.  On
the CPU it runs in interpret mode, as the JAX package's own tests run its
kernels; the port's wrapper runs its twin there (``torch.gather``).  The
gather is exact, so the two must agree bit for bit.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from pysolvers_tpu_torch.ops import probe

_PROBE = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                      "probe_idx16.py")


def _jax_probe():
    spec = importlib.util.spec_from_file_location("probe_idx16", _PROBE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pallas_gather(idx, x):
    """The probe's kernel body (``probe_idx16.py:27-30``) in interpret
    mode on any (rows, 128) tile."""
    def kernel(idx_ref, x_ref, o_ref):
        with jax.enable_x64(False):
            ii = idx_ref[...].astype(jnp.int32)
            o_ref[...] = jnp.take_along_axis(x_ref[...], ii, axis=1)

    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True)(jnp.asarray(idx), jnp.asarray(x)))


def test_probe_runs_as_the_jax_probe():
    assert _jax_probe().main() == 0
    assert probe.probe_main("cpu") == 0.0


@pytest.mark.parametrize("rows,seed", [(8, 0), (8, 1), (16, 2), (1, 3)])
def test_twin_matches_the_pallas_probe(rows, seed):
    rng = np.random.default_rng(seed)
    x = rng.random((rows, 128)).astype(np.float32)
    idx = rng.integers(0, 128, size=(rows, 128)).astype(np.int16)
    before = probe.lane_gather_probe_launches
    out = probe.lane_gather_probe(torch.from_numpy(idx), torch.from_numpy(x))
    assert probe.lane_gather_probe_launches == before     # no kernel here
    np.testing.assert_array_equal(out.numpy(), _pallas_gather(idx, x))


@pytest.mark.parametrize("bad", [-1, 128, 32767])
def test_cpu_path_checks_the_range_eagerly(bad):
    idx = np.zeros((8, 128), np.int16)
    idx[3, 77] = bad
    with pytest.raises(ValueError, match=r"\[0, 128\)"):
        probe.lane_gather_probe(torch.from_numpy(idx),
                                torch.zeros((8, 128), dtype=torch.float32))


def test_wrapper_refuses_wrong_types_and_shapes():
    x = torch.zeros((8, 128), dtype=torch.float32)
    with pytest.raises(TypeError):
        probe.lane_gather_probe(torch.zeros((8, 128), dtype=torch.int32), x)
    with pytest.raises(ValueError, match="128"):
        probe.lane_gather_probe(torch.zeros((8, 64), dtype=torch.int16),
                                x[:, :64])

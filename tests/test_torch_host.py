"""The port's host layer against the JAX package: generated problems,
HostCSR algebra, the native plans and the SA-AMG setup must be bit-equal
(the port copies these numpy modules; both bind the same native library)."""
import numpy as np
import pytest
import torch

import pysolvers_tpu.linear.amg as jamg
import pysolvers_tpu.problems as jprob
import pysolvers_tpu.sparse.host as jhost
import pysolvers_tpu.utils.native as jnative
import pysolvers_tpu_torch.linear.amg as tamg
import pysolvers_tpu_torch.problems as tprob
import pysolvers_tpu_torch.sparse.host as thost
import pysolvers_tpu_torch.utils.native as tnative

torch.set_num_threads(1)


def _same_csr(a, b):
    assert a.shape == b.shape
    for f in ("indptr", "indices", "data"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def _random_csr(mod, n=60, m=None, density=0.08, seed=0):
    rng = np.random.default_rng(seed)
    m = n if m is None else m
    dense = rng.standard_normal((n, m)) * (rng.random((n, m)) < density)
    dense[np.arange(min(n, m)), np.arange(min(n, m))] += 4.0
    return mod.HostCSR.from_dense(dense)


@pytest.mark.parametrize("gen,m", [("fd_laplacian_1d", 17),
                                   ("fd_laplacian_2d", 13),
                                   ("fd_laplacian_2d", 48)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_problems_bit_equal(gen, m, dtype):
    _same_csr(getattr(jprob, gen)(m, dtype=dtype),
              getattr(tprob, gen)(m, dtype=dtype))


@pytest.mark.parametrize("op", ["transpose", "matmat", "permute",
                                "lower", "upper", "matvec", "diagonal"])
def test_hostcsr_bit_equal(op):
    ja, ta = _random_csr(jhost), _random_csr(thost)
    jb, tb = _random_csr(jhost, seed=1), _random_csr(thost, seed=1)
    perm = np.random.default_rng(2).permutation(ja.shape[0])
    x = np.random.default_rng(3).standard_normal(ja.shape[1])
    if op == "transpose":
        _same_csr(ja.transpose(), ta.transpose())
    elif op == "matmat":
        _same_csr(ja.matmat(jb), ta.matmat(tb))
    elif op == "permute":
        _same_csr(ja.permute_symmetric(perm), ta.permute_symmetric(perm))
    elif op == "lower":
        _same_csr(ja.extract_lower(), ta.extract_lower())
    elif op == "upper":
        _same_csr(ja.extract_upper(), ta.extract_upper())
    elif op == "matvec":
        np.testing.assert_array_equal(ja.matvec(x), ta.matvec(x))
    else:
        np.testing.assert_array_equal(ja.diagonal(), ta.diagonal())


@pytest.mark.parametrize("plan", ["aggregate", "rcm", "sym_rcm",
                                  "levelize_lower", "levelize_upper",
                                  "spgemm", "permute_plan"])
def test_native_plans_bit_equal(plan):
    H = jprob.fd_laplacian_2d(24)
    n = H.shape[0]
    args = (H.indptr, H.indices, n)
    if plan == "spgemm":
        call = lambda mod: mod.spgemm(H.indptr, H.indices, H.data, H.indptr,
                                      H.indices, H.data, H.shape, H.shape)
    elif plan == "permute_plan":
        perm = np.random.default_rng(0).permutation(n)
        call = lambda mod: mod.csr_permute_plan(H.indptr, H.indices, perm)
    elif plan.startswith("levelize"):
        call = lambda mod: mod.levelize(*args, lower=plan.endswith("lower"))
    else:
        call = lambda mod: getattr(mod, plan)(*args)
    got_j, got_t = call(jnative), call(tnative)
    assert got_t is not None, "native library did not load in the port"
    if not isinstance(got_j, tuple):
        got_j, got_t = (got_j,), (got_t,)
    assert len(got_j) == len(got_t)
    for a, b in zip(got_j, got_t):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("part", ["aggregates", "P", "R", "A_c"])
def test_sa_setup_bit_equal(part):
    """SA aggregates, P, R and the Galerkin A_c at m = 48, 3 levels."""
    Hj, Ht = jprob.fd_laplacian_2d(48), tprob.fd_laplacian_2d(48)
    if part == "aggregates":
        np.testing.assert_array_equal(jamg.build_aggregates(Hj, 0.08),
                                      tamg.build_aggregates(Ht, 0.08))
        return
    hj = jamg.build_sa_hierarchy(Hj, num_levels=3)
    ht = tamg.build_sa_hierarchy(Ht, num_levels=3)
    assert ht.n_levels == hj.n_levels == 3
    pick = {"P": "prolongators", "R": "restrictions", "A_c": "matrices"}[part]
    for a, b in zip(getattr(hj, pick), getattr(ht, pick)):
        _same_csr(a, b)

"""The block lane's PCG + per-field SA multigrid (``solve(BdiaMatrix,
precond="bmg")``) against the plain reference (``tests/plain_block_mg.py``:
plain torch, float64, node-major ``torch.sparse`` operators, no planar
layout) on seeded random inputs: K4's twin, each field's subsystem, each
field's hierarchy, one apply, whole solves; and the lane's spans and
counters over a warm-up solve and frozen re-solves."""
import filecmp
import importlib
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import pysolvers_tpu_torch as pt
from pysolvers_tpu_torch.linear.amg import (build_aggregates,
                                            build_sa_hierarchy)
import pysolvers_tpu_torch.linear.block_precond as tbp
from pysolvers_tpu_torch.linear.block_precond import (
    BlockMGBdiaPreconditionerType, bdia_dof_subsystem)
from pysolvers_tpu_torch.ops.spmv import bdia_spmv
from pysolvers_tpu_torch.sparse.host import HostCSR
from pysolvers_tpu_torch.utils.timing import Timer

HERE = os.path.dirname(__file__)
sys.path.insert(0, HERE)
import plain_block_mg as ref  # noqa: E402

# the module: the package's ``solve`` is the function
tsolve = importlib.import_module("pysolvers_tpu_torch.solve")

torch.set_num_threads(1)

CASES = [(8, 2), (8, 5), (16, 2), (16, 5), (24, 2), (24, 5)]
COUPLING = 0.2
TAU = 1e-10
# one apply is, per field, 5 sparse products and a few vector passes on
# each of 2 smoothed levels plus the coarsest solve, each rounding at
# ~1e-16, summed in other orders than the reference's (DIA and ELL
# products, the coarsest inverse against a dense solve): tens of float64
# roundings.  A float32 apply misses it by 1e-8 or more.
APPLY_RTOL = 1e-12
# the fine operator's products sum at most 5·b terms in another order
PRODUCT_RTOL = 1e-14


def couplings(b):
    """The vector Laplacian's C, and an SPD C with a diagonal of its own
    per field (so that a field taken for another shows)."""
    rng = np.random.default_rng(100 + b)
    G = rng.uniform(-0.1, 0.1, (b, b))
    C = np.diag(rng.uniform(1.0, 3.0, b)) + 0.5 * (G + G.T) / b
    return {"vector": ref.coupling_matrix(b, COUPLING),
            "random": torch.as_tensor(C)}


def port_operator(A_ref, b, dtype=np.float64):
    """The reference's matrix as the port's CPU BdiaMatrix, packed from a
    HostCSR as a user holding one packs it."""
    idx = A_ref.indices().numpy()
    H = HostCSR.from_coo(idx[0], idx[1], A_ref.values().numpy(),
                         tuple(A_ref.shape))
    return H, pt.BdiaMatrix.from_host_csr(H, b, dtype=dtype, device="cpu")


def _rel_inf(y, y_ref):
    y, y_ref = y.double(), y_ref.double()
    return float((y - y_ref).abs().max() / y_ref.abs().max())


def _dense(H):
    return torch.as_tensor(H.to_dense())


@pytest.mark.parametrize("m,b", CASES)
def test_the_reference_operator_is_the_vector_laplacian(m, b):
    A_ref = ref.block_operator(m, ref.coupling_matrix(b, COUPLING))
    H = pt.fd_vector_laplacian_2d(m, b=b, coupling=COUPLING)
    assert torch.equal(A_ref.to_dense(), _dense(H))


@pytest.mark.parametrize("coupling", ["vector", "random"])
@pytest.mark.parametrize("m,b", CASES)
def test_the_k4_twin_is_the_reference_product(m, b, coupling):
    A_ref = ref.block_operator(m, couplings(b)[coupling])
    _, A = port_operator(A_ref, b)
    x = torch.as_tensor(np.random.default_rng(m * b).random(A.n_rows))
    y = A.from_planar(bdia_spmv(A, A.to_planar(x)))
    assert _rel_inf(y, ref._mv(A_ref, x)) <= PRODUCT_RTOL


@pytest.mark.parametrize("m,b", CASES)
def test_each_field_subsystem_is_the_references(m, b):
    A_ref = ref.block_operator(m, couplings(b)["random"])
    _, A = port_operator(A_ref, b)
    for p in range(b):
        assert torch.equal(_dense(bdia_dof_subsystem(A, p)),
                           ref.field(A_ref, p, b).to_dense())


@pytest.mark.parametrize("m,b", CASES)
def test_each_field_hierarchy_is_the_references(m, b):
    """P, R and A_c of every coarsening within 1e-12 of the reference's,
    the aggregates equal; 3 levels, as "bmg" builds them."""
    A_ref = ref.block_operator(m, couplings(b)["random"])
    _, A = port_operator(A_ref, b)
    for p in range(b):
        S, F = bdia_dof_subsystem(A, p), ref.field(A_ref, p, b)
        agg = build_aggregates(S, 0.08)
        assert torch.equal(torch.as_tensor(agg, dtype=torch.int64),
                           ref.aggregates(F, ref.strength(F, 0.08)))
        mlh = build_sa_hierarchy(S, 3)
        levels = ref.hierarchy(F, 3)
        assert mlh.n_levels == len(levels) == 3
        for k, (_, _, P, R) in enumerate(levels[:-1]):
            j = mlh.n_levels - 1 - k          # the port counts coarsest-first
            A_c = levels[k + 1][0]
            for port, mine in ((mlh.prolongators[j - 1], P),
                               (mlh.restrictions[j - 1], R),
                               (mlh.matrices[j - 1], A_c)):
                assert tuple(port.shape) == tuple(mine.shape)
                assert _rel_inf(_dense(port), mine.to_dense()) <= 1e-12


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("m,b", CASES)
def test_one_apply_matches_the_plain_reference(m, b, dtype):
    """float64 within APPLY_RTOL; the same apply in float32 falls outside
    it, so the tolerance tells the two precisions apart."""
    A_ref = ref.block_operator(m, couplings(b)["random"])
    _, A = port_operator(A_ref, b, dtype=np.dtype(dtype))
    v = torch.as_tensor(np.random.default_rng(7 * m + b).standard_normal(
        A.n_rows))
    y_ref = ref.apply(ref.field_hierarchies(A_ref, b), v)
    prec = BlockMGBdiaPreconditionerType().form(A_dev=A)
    y = A.from_planar(prec.apply_any(A.to_planar(v.to(A.dtype))))
    err = _rel_inf(y, y_ref)
    if dtype == "float64":
        assert err <= APPLY_RTOL
    else:
        assert err > APPLY_RTOL


@pytest.mark.parametrize("coupling", ["vector", "random"])
@pytest.mark.parametrize("m,b", CASES)
def test_a_whole_solve_matches_the_plain_reference(m, b, coupling):
    A_ref = ref.block_operator(m, couplings(b)[coupling])
    H, A = port_operator(A_ref, b)
    rhs = H.matvec(np.random.default_rng(m + b).random(A.n_rows))
    st = pt.solve(A, rhs, tau=TAU, maxiter=500, method="cg", precond="bmg")
    hs = ref.field_hierarchies(A_ref, b)
    x_ref, iters = ref.pcg(A_ref, torch.as_tensor(rhs),
                           lambda r: ref.apply(hs, r), tau=TAU)
    assert st.success and abs(st.iters - iters) <= 1
    norm = torch.linalg.vector_norm
    assert float(norm(st.soln - x_ref) / norm(x_ref)) <= 1e-8


@pytest.mark.parametrize("b", [2, 5])
def test_a_re_solve_forms_nothing_and_counts_its_work(monkeypatch, b):
    """Over a warm-up solve and 5 re-solves of one BdiaMatrix: the b
    hierarchies built once ("bdia.bmg_setup" 1, "amg.coarse_inverse" b);
    "bmg.applies" and "bdia.products" each iterations + 1 a solve (CG's
    initial residual and apply, then one of each an iteration); a
    re-solve reads the host only for CG (its stop tests and the status's
    two reads); with the profiler off no traced span is recorded, with it
    on one "bmg.apply" per apply and one "bmg.field" per field in each."""
    monkeypatch.setattr(tsolve, "_BDIA_SOLVE_CACHE", {})
    H = pt.fd_vector_laplacian_2d(16, b=b, coupling=COUPLING)
    A = pt.BdiaMatrix.from_host_csr(H, b, device="cpu")
    rng = np.random.default_rng(b)
    Timer.reset()
    total = 0
    for k in range(6):
        reads = Timer.calls("host_reads")
        st = pt.solve(A, H.matvec(rng.random(A.n_rows)), tau=TAU,
                      maxiter=500, method="cg", precond="bmg")
        assert st.success
        total += st.iters + 1
        if k:
            assert Timer.calls("host_reads") - reads == st.iters + 3
    assert Timer.calls("bdia.bmg_setup") == 1
    assert Timer.calls("amg.coarse_inverse") == b
    assert Timer.calls("bmg.applies") == total
    assert Timer.calls("bdia.products") == total
    assert Timer.calls("bmg.graph_replays") == 0      # the CPU stays eager
    for name in ("bmg.apply", "bmg.field"):
        assert Timer.calls(name) == 0 and Timer.total(name) == 0.0

    Timer.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        st = pt.solve(A, H.matvec(rng.random(A.n_rows)), tau=TAU,
                      maxiter=500, method="cg", precond="bmg")
    applies = st.iters + 1
    assert Timer.calls("bmg.applies") == Timer.calls("bmg.apply") == applies
    assert Timer.calls("bmg.field") == b * applies
    assert Timer.total("bmg.apply") >= Timer.total("bmg.field") > 0.0
    assert Timer.calls("bdia.bmg_setup") == 0


def _form_and_apply(b, device, n_applies=3):
    """A "bmg" apply formed on fd_vector_laplacian_2d(16, b) on
    ``device``, and its results on ``n_applies`` seeded vectors."""
    H = pt.fd_vector_laplacian_2d(16, b=b, coupling=COUPLING)
    A = pt.BdiaMatrix.from_host_csr(H, b, device=device)
    prec = BlockMGBdiaPreconditionerType().form(A_dev=A)
    gen = torch.Generator().manual_seed(b)
    vs = [torch.randn(A.n_rows, generator=gen, dtype=torch.float64).to(
        device) for _ in range(n_applies)]
    return [prec.apply_any(v) for v in vs]


def test_the_graph_wraps_the_whole_apply_where_the_amg_rule_holds(
        monkeypatch):
    """Where ``amg._replays_as_graph`` holds for every field's hierarchy
    (one CUDA device, a sync-free smoother), one ``GraphedApply`` named
    "bmg" serves the b fields' V-cycles of each apply; its results are the
    eager apply's."""
    made = []

    class Recording:
        def __init__(self, fn, name, device):
            made.append((name, torch.device(device)))
            self.fn = fn

        def __call__(self, v):
            return self.fn(v)
    eager = _form_and_apply(3, "cpu")
    monkeypatch.setattr(tbp, "_replays_as_graph", lambda h, mesh: True)
    monkeypatch.setattr(tbp, "GraphedApply", Recording)
    for y, y_eager in zip(_form_and_apply(3, "cpu"), eager):
        assert torch.equal(y, y_eager)
    assert made == [("bmg", torch.device("cpu"))]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b", [2, 5])
def test_the_replayed_apply_is_the_eager_one_on_the_card(cuda, monkeypatch,
                                                         b):
    """On the card: the first apply eager, the second captured, the rest
    replayed, each bit-equal to an eager apply of the same input."""
    Timer.reset()
    graphed = _form_and_apply(b, cuda, n_applies=4)
    assert Timer.calls("bmg.graph_captures") == 1
    assert Timer.calls("bmg.graph_replays") == 3
    monkeypatch.setattr(tbp, "_replays_as_graph", lambda h, mesh: False)
    for y, y_eager in zip(graphed, _form_and_apply(b, cuda, n_applies=4)):
        assert torch.equal(y, y_eager)


def test_the_benchmark_holds_the_same_reference():
    """The benchmark's copy, for the comparison on the card at full width,
    is this file byte for byte."""
    copy = os.path.join(HERE, os.pardir, "solverbench", "plain",
                        "plain_block_mg.py")
    assert filecmp.cmp(os.path.join(HERE, "plain_block_mg.py"), copy,
                       shallow=False)

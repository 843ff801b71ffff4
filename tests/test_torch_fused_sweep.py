"""The multigrid level's Jacobi sweep and residual as one launch of K1 or K6
with an epilogue (``ops/sweep.py``, ``csrc/sweep_epilogue.cuh``).

On the CPU (tier-1): ``jacobi_sweep`` and ``residual`` are the unfused
lines exactly; the rule that takes the kernel route admits nothing on the
CPU and refuses what the epilogue cannot read (rectangular, mixed dtypes,
strided or ``torch.func`` vectors) on any device; the counters "smooth.jacobi_sweeps" and "smooth.fused_sweeps";
GMG and SA applies through ``amg._smooth`` equal the unfused V-cycle; the
benchmark's reader of the fused share (none off the card).

On the card (``cuda``, skipped without one; this file imports neither jax
nor pysolvers_tpu, so it runs on a GPU machine without JAX)::

    python -m pytest --noconftest tests/test_torch_fused_sweep.py -q

the rule admits square DIA and grid-DIA operators and no other (ELL,
BWS) and refuses the same inputs there; the fused sweep and residual
against the product followed by torch's
elementwise passes, bit for bit, on K1 (f64 and f32; D = 5, a D = 9 box,
offsets that leave the matrix on both sides, ld > n) and K6 (D = 5 at
m = 4096, a D = 9 box, narrow grids that pack rows into a block); whole
GMG and SA applies against the unfused V-cycle; a CUDA graph's replay of
a fused apply against the eager apply.
"""
import pytest
import torch

import pysolvers_tpu_torch as pt
import pysolvers_tpu_torch.linear.amg as tamg
import pysolvers_tpu_torch.linear.gmg_grid as tgg
from pysolvers_tpu_torch.ops import _cuda_build, grid_spmv, matvec, spmv, sweep
from pysolvers_tpu_torch.ops.grid_spmv import GridDiaMatrix
from pysolvers_tpu_torch.sparse.bws import BwsCsrMatrix
from pysolvers_tpu_torch.sparse.device import DiaMatrix, EllMatrix
from pysolvers_tpu_torch.utils.timing import Timer

OMEGA = 2.0 / 3.0


@pytest.fixture
def clean_timers():
    Timer.reset()
    yield
    Timer.reset()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1's and K6's epilogues have no "
                    "CPU mode)")
    return torch.device("cuda")


def _unfused_sweep(A, x, f, dinv, omega=OMEGA):
    """The sweep as ``amg._smooth`` wrote it before the epilogue."""
    r = f - matvec(A, x)
    return x + omega * dinv.to(x.dtype) * r


def _vectors(n, dtype, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x, f = (torch.rand(n, generator=gen, dtype=torch.float64) - 0.5
            for _ in range(2))
    dinv = 0.2 + torch.rand(n, generator=gen, dtype=torch.float64)
    return (x.to(dtype).to(device), f.to(dtype).to(device),
            dinv.to(dtype).to(device))


def _parent_v_cycle(h, f, x):
    """``amg.v_cycle`` / ``gmg_grid.v_cycle_grid`` with the Jacobi smoother
    as unfused lines: the residual and every sweep a product followed by
    torch's elementwise passes."""
    grid = isinstance(h, tgg.GridHierarchy)

    def smooth(lev, x_k, f_k, sweeps):
        for _ in range(sweeps):
            x_k = _unfused_sweep(lev.A_dev, x_k, f_k, lev.dinv)
        return x_k

    def run(k, f_k, x_k):
        if k == 0:
            return h.A0_inv.to(f_k.dtype) @ f_k
        lev = h.levels[k]
        x_k = smooth(lev, x_k, f_k, h.nu_pre)
        r = f_k - matvec(lev.A_dev, x_k)
        if grid:
            f_c = tgg.grid_restrict(r, h.ndim, h.ms[k], h.ms[k - 1])
            x_c = run(k - 1, f_c, torch.zeros_like(f_c))
            x_k = x_k + tgg.grid_prolong(x_c, h.ndim, h.ms[k - 1], h.ms[k])
        else:
            f_c = matvec(lev.R_dev, r)
            x_c = run(k - 1, f_c, torch.zeros_like(f_c))
            x_k = x_k + matvec(lev.P_dev, x_c)
        return smooth(lev, x_k, f_k, h.nu_post)

    return run(h.n_levels - 1, f, x)


def _parent_apply(h, v, num_iters=2):
    x = torch.zeros_like(v)
    for _ in range(num_iters):
        x = _parent_v_cycle(h, v, x)
    return x


def _grid_hierarchy(m, levels, device, dtype=torch.float64):
    H = pt.problems.fd_laplacian_2d(m)
    A = DiaMatrix.from_host_csr(H, dtype=dtype, device=device)
    return tgg.build_grid_hierarchy_device(A, levels, (m, m),
                                           smoother="jacobi")


def _sa_hierarchy(m, device):
    """A DIA fine level on K1 and ELL coarse levels."""
    H = pt.problems.fd_laplacian_2d(m)
    prec = pt.AMG(num_iters=2, num_levels=3, galerkin="host",
                  smoother="jacobi").form(H, device=device)
    kinds = [type(lvl.A_dev).__name__ for lvl in prec.state.levels[1:]]
    assert kinds == ["EllMatrix", "DiaMatrix"]
    return prec


# ---------------------------------------------------------------------------
# CPU: the unfused lines, the rule, the counters, the applies
# ---------------------------------------------------------------------------

def _operators(dtype, device="cpu"):
    """One of each format the smoother meets, 15² rows."""
    H = pt.problems.fd_laplacian_2d(15)
    dia = DiaMatrix.from_host_csr(H, dtype=dtype, device=device)
    return {"dia": dia, "grid": GridDiaMatrix.from_dia(dia, (15, 15)),
            "ell": EllMatrix.from_host_csr(H, dtype=dtype, device=device),
            "bws": BwsCsrMatrix.from_host_csr(H, dtype=dtype, device=device)}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("fmt", ["dia", "grid", "ell", "bws"])
def test_cpu_ops_are_the_unfused_lines(fmt, dtype, clean_timers):
    A = _operators(dtype)[fmt]
    x, f, dinv = _vectors(A.shape[0], dtype, "cpu")
    assert torch.equal(sweep.jacobi_sweep(A, x, f, dinv, OMEGA),
                       _unfused_sweep(A, x, f, dinv))
    assert torch.equal(sweep.residual(A, f, x), f - matvec(A, x))
    assert Timer.calls("smooth.jacobi_sweeps") == 1
    assert Timer.calls("smooth.fused_sweeps") == 0


def _admitted(device):
    """The formats the rule admits, by dtype, with vectors that fit."""
    seen = {}
    for dtype in (torch.float64, torch.float32):
        ops = _operators(dtype, device)
        x, f, dinv = _vectors(225, dtype, device)
        seen[dtype] = sorted(k for k, A in ops.items()
                             if sweep.epilogue_takes(A, x, f, dinv))
    return seen


def _assert_refusals(device):
    """What the epilogue cannot read is refused on any device."""
    A = _operators(torch.float64, device)["dia"]
    x, f, dinv = _vectors(225, torch.float64, device)
    assert not sweep.epilogue_takes(A, x, f, dinv.float())       # dtypes
    assert not sweep.epilogue_takes(A, x.float(), f, dinv)
    assert not sweep.epilogue_takes(A, x, f, torch.ones(
        226, dtype=torch.float64, device=device))
    wide = torch.rand(225, 2, dtype=torch.float64, device=device)
    assert not sweep.epilogue_takes(A, x, wide[:, 0], dinv)      # strided
    # a rectangular DIA operator (a transfer) never takes the route
    P = DiaMatrix(A.diags, A.offsets, A.offsets_dev, (225, 240))
    assert not sweep.epilogue_takes(P, x, f)
    seen = []

    def probe(v):
        seen.append(sweep.epilogue_takes(A, v, f))
        return v

    torch.func.jvp(probe, (x,), (torch.ones_like(x),))
    assert seen == [False]                                       # torch.func


def test_the_rule_admits_square_dia_and_grid_dia():
    """On the CPU no operator takes the route: the epilogues are CUDA
    kernels, so the ops run the unfused lines whatever the format."""
    assert _admitted("cpu") == {torch.float64: [], torch.float32: []}


def test_the_rule_refuses_what_the_epilogue_cannot_read():
    _assert_refusals("cpu")


def test_cpu_rectangular_and_mixed_inputs_run_the_unfused_lines(
        clean_timers):
    A = _operators(torch.float64)["dia"]
    x, f, dinv = _vectors(225, torch.float64, "cpu")
    d32 = dinv.float()
    assert torch.equal(sweep.jacobi_sweep(A, x, f, d32, OMEGA),
                       _unfused_sweep(A, x, f, d32))
    H = pt.problems.fd_laplacian_2d(15)
    R = DiaMatrix.from_host_csr(H, device="cpu")
    R = DiaMatrix(R.diags, R.offsets, R.offsets_dev, (225, 230))
    x_wide = torch.rand(230, dtype=torch.float64)
    assert torch.equal(sweep.residual(R, f, x_wide),
                       f - matvec(R, x_wide))
    assert Timer.calls("smooth.jacobi_sweeps") == 1
    assert Timer.calls("smooth.fused_sweeps") == 0


@pytest.mark.parametrize("smoother, sweeps", [("jacobi", 16),
                                              ("chebyshev", 0)])
def test_counters_count_every_jacobi_sweep(smoother, sweeps, clean_timers):
    """Two V-cycles over two smoothed levels, ν₁ = ν₂ = 2: 16 sweeps."""
    H = pt.problems.fd_laplacian_2d(31)
    A = DiaMatrix.from_host_csr(H, device="cpu")
    h = tgg.build_grid_hierarchy_device(A, 3, (31, 31), smoother=smoother)
    tgg.grid_vc_apply(2)(h, torch.rand(961, dtype=torch.float64))
    assert Timer.calls("smooth.jacobi_sweeps") == sweeps
    assert Timer.calls("smooth.fused_sweeps") == 0


def test_cpu_gmg_apply_is_the_unfused_cycle(monkeypatch):
    monkeypatch.setattr(tgg, "GRID_KERNEL_MIN_M", 7)     # grid-DIA levels
    h = _grid_hierarchy(31, 4, "cpu")
    assert {type(L.A_dev) for L in h.levels[1:]} == {GridDiaMatrix}
    v = torch.rand(961, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(3))
    assert torch.equal(tgg.grid_vc_apply(2)(h, v), _parent_apply(h, v))


def test_cpu_sa_apply_is_the_unfused_cycle():
    prec = _sa_hierarchy(63, "cpu")
    v = torch.rand(63 * 63, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(4))
    assert torch.equal(prec.apply_any(v), _parent_apply(prec.state, v))


def _traced(busy_s):
    from types import SimpleNamespace
    return SimpleNamespace(trace=SimpleNamespace(busy_s=busy_s))


def test_reader_fused_sweep_share(clean_timers):
    from solverbench.lib import spec as S
    read = S.metric_reader("precond.fused_sweep_share")
    on_card = _traced(0.5)
    assert read(on_card) is None            # a program without the counter
    Timer.count("smooth.jacobi_sweeps", 40)
    assert read(on_card) == 0.0
    Timer.count("smooth.fused_sweeps", 30)
    assert read(on_card) == pytest.approx(75.0)


def test_reader_fused_sweep_share_reads_nothing_off_the_card(clean_timers):
    """A traced window with no device time ran on the CPU, where no
    kernel can serve a sweep: the share is not read there."""
    from types import SimpleNamespace

    from solverbench.lib import spec as S
    read = S.metric_reader("precond.fused_sweep_share")
    Timer.count("smooth.jacobi_sweeps", 40)
    assert read(_traced(0.0)) is None
    assert read(SimpleNamespace(trace=None)) is None


# ---------------------------------------------------------------------------
# CUDA: the epilogues against the unfused card path, bit for bit
# ---------------------------------------------------------------------------

def _check_bit_equal(A, dtype, cuda, seed=0):
    n = A.shape[0]
    x, f, dinv = _vectors(n, dtype, cuda, seed)
    launches = (spmv.dia_spmv_launches, grid_spmv.grid_dia_spmv_launches)
    fused = sweep.jacobi_sweep(A, x, f, dinv, OMEGA)
    r = sweep.residual(A, f, x)
    after = (spmv.dia_spmv_launches, grid_spmv.grid_dia_spmv_launches)
    assert sum(after) - sum(launches) == 2          # one launch each
    ref = _unfused_sweep(A, x, f, dinv)
    assert torch.equal(r, f - matvec(A, x))
    assert torch.equal(fused, ref)
    assert fused.data_ptr() != x.data_ptr()
    # the plain twin on the CPU agrees to rounding
    ref_cpu = _unfused_sweep(_to_cpu(A), x.cpu(), f.cpu(), dinv.cpu())
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert float((fused.cpu() - ref_cpu).abs().max()) <= tol * float(
        ref_cpu.abs().max())


def _to_cpu(A):
    if isinstance(A, DiaMatrix):
        return DiaMatrix(A.diags.cpu(), A.offsets, A.offsets_dev.cpu(),
                         A.shape)
    return GridDiaMatrix._make(A.diags.cpu(), A.pairs, A.dims)


def _dia(offsets, n, ld, dtype, cuda, seed=1):
    gen = torch.Generator().manual_seed(seed)
    diags = torch.rand(len(offsets), ld, generator=gen,
                       dtype=torch.float64).to(dtype)
    return DiaMatrix(diags.to(cuda), tuple(offsets),
                     torch.tensor(offsets, dtype=torch.int32, device=cuda),
                     (n, n))


K1_CASES = {
    "five_point": lambda n, m: (-m, -1, 0, 1, m),
    "box9": lambda n, m: tuple(a * m + b for a in (-1, 0, 1)
                               for b in (-1, 0, 1)),
    "both_edges": lambda n, m: (-(n - 3), -7, 0, 5, n - 2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", sorted(K1_CASES))
@pytest.mark.parametrize("pad", [0, 37])                  # ld = n + pad
def test_k1_epilogues_are_the_unfused_path(cuda, case, dtype, pad,
                                           clean_timers):
    m = 257
    n = m * m
    A = _dia(K1_CASES[case](n, m), n, n + pad, dtype, cuda)
    _check_bit_equal(A, dtype, cuda)
    assert Timer.calls("smooth.fused_sweeps") == 1


def _grid(pairs, dims, dtype, cuda, seed=2):
    mr, mc = dims
    gen = torch.Generator().manual_seed(seed)
    ldc = grid_spmv._ceil_to(mc, grid_spmv.ROW_ALIGN)
    G = torch.zeros(len(pairs), mr, ldc, dtype=dtype)
    G[:, :, :mc] = torch.rand(len(pairs), mr, mc, generator=gen,
                              dtype=torch.float64).to(dtype)
    return GridDiaMatrix._make(G.to(cuda), pairs, dims)


FIVE = ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0))
BOX9 = tuple((a, b) for a in (-1, 0, 1) for b in (-1, 0, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("pairs, dims", [
    (FIVE, (4096, 4096)),          # the GMG fine width
    (BOX9, (511, 513)),            # a probed level's box
    (BOX9, (300, 100)),            # mc < 256: two grid rows a block
    (FIVE, (97, 37)),              # four grid rows a block
])
def test_k6_epilogues_are_the_unfused_path(cuda, pairs, dims, dtype,
                                           clean_timers):
    _check_bit_equal(_grid(pairs, dims, dtype, cuda), dtype, cuda)


@pytest.mark.cuda
def test_the_rule_admits_square_dia_and_grid_dia_on_the_card(cuda):
    assert _admitted(cuda) == {torch.float64: ["dia", "grid"],
                               torch.float32: ["dia", "grid"]}


@pytest.mark.cuda
def test_the_rule_refuses_what_the_epilogue_cannot_read_on_the_card(cuda):
    _assert_refusals(cuda)


@pytest.mark.cuda
def test_unknown_epilogue_code_is_refused(cuda):
    A = _dia(K1_CASES["five_point"](64 * 64, 64), 64 * 64, 64 * 64,
             torch.float64, cuda)
    x = torch.rand(64 * 64, dtype=torch.float64, device=cuda)
    with pytest.raises(RuntimeError, match="K1"):
        spmv.k1_launch(A, x, x, x, OMEGA, 3)


@pytest.mark.cuda
def test_other_levels_run_the_unfused_lines_on_the_card(cuda, clean_timers):
    H = pt.problems.fd_laplacian_2d(63)
    E = EllMatrix.from_host_csr(H, device=cuda)
    x, f, dinv = _vectors(H.shape[0], torch.float64, cuda)
    before = spmv.dia_spmv_launches
    assert torch.equal(sweep.jacobi_sweep(E, x, f, dinv, OMEGA),
                       _unfused_sweep(E, x, f, dinv))
    A = DiaMatrix.from_host_csr(H, device=cuda)
    assert torch.equal(sweep.jacobi_sweep(A, x, f, dinv.float(), OMEGA),
                       _unfused_sweep(A, x, f, dinv.float()))
    # the mixed sweep and its reference: a product each, no epilogue
    assert spmv.dia_spmv_launches == before + 2
    assert Timer.calls("smooth.jacobi_sweeps") == 2
    assert Timer.calls("smooth.fused_sweeps") == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_gmg_apply_is_the_unfused_cycle(cuda, dtype, monkeypatch,
                                        clean_timers):
    """K6 on the 2-D levels of m >= 31, K1 on m = 15 (m = 7 is the
    coarsest, a dense inverse); every sweep fused."""
    monkeypatch.setattr(tgg, "GRID_KERNEL_MIN_M", 31)
    h = _grid_hierarchy(127, 5, cuda, dtype)
    kinds = [type(L.A_dev).__name__ for L in h.levels[1:]]
    assert kinds == ["DiaMatrix", "GridDiaMatrix", "GridDiaMatrix",
                     "GridDiaMatrix"]
    v = torch.rand(127 * 127, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(6)).to(dtype)
    out = tgg.grid_vc_apply(2)(h, v.to(cuda))
    assert Timer.calls("smooth.fused_sweeps") == 2 * 4 * 4
    assert Timer.calls("smooth.jacobi_sweeps") == 2 * 4 * 4
    assert torch.equal(out, _parent_apply(h, v.to(cuda)))


@pytest.mark.cuda
def test_sa_apply_is_the_unfused_cycle(cuda, monkeypatch, clean_timers):
    monkeypatch.setattr(tamg, "GraphedApply", lambda fn, name, device: fn)
    prec = _sa_hierarchy(255, cuda)
    v = torch.rand(255 * 255, dtype=torch.float64, device=cuda)
    out = prec.apply_any(v)
    # the fine level's 8 sweeps fused, the ELL level's 8 not
    assert Timer.calls("smooth.jacobi_sweeps") == 16
    assert Timer.calls("smooth.fused_sweeps") == 8
    assert torch.equal(out, _parent_apply(prec.state, v))


@pytest.mark.cuda
def test_a_graph_replays_the_fused_apply(cuda, clean_timers):
    prec = _sa_hierarchy(255, cuda)
    gen = torch.Generator().manual_seed(7)
    vs = [torch.rand(255 * 255, generator=gen, dtype=torch.float64).to(cuda)
          for _ in range(3)]
    outs = [prec.apply_any(v) for v in vs]           # eager, capture, replay
    assert Timer.calls("amg.graph_captures") == 1
    assert Timer.calls("amg.graph_replays") == 2
    assert Timer.calls("smooth.fused_sweeps") == 2 * 8  # eager + capture
    for v, out in zip(vs, outs):
        assert torch.equal(out, _parent_apply(prec.state, v))
    assert _cuda_build.launches_by_dtype["K1", "float64"] > 0

"""Probe the multigrid level's Jacobi sweep and residual as one launch of K1
or K6 with its epilogue (``ops/sweep.py``) against the unfused lines (the
product, then torch's elementwise passes), on the card, at the sizes of the
GMG solve at n = 1.05e8.  Imports the port only (no jax).

    python3 benchmarks/torch_fused_sweep_probe.py [--reps 20] [--blocks 5]
        [--out benchmarks/data/fused_sweep_probe.jsonl]

Cases: K1 on the 5-point fine operator at m = 10239 (D = 5, n =
104,837,121), and K6 on a 9-point box at m = 5119 (the probed level's
shape, D = 9, random entries), each in f64 and f32.  For each, first
whether the fused sweep and residual equal the unfused lines bit for bit,
then per op the milliseconds of one call (CUDA events over ``reps`` calls,
the median of ``blocks`` blocks, the unfused and fused ops in turns, each
primed by an untimed call) beside its least time at 3.35 TB/s: (D + 2)
words a row for the product, (D + 3) for the residual, (D + 4) for the
sweep, and for the unfused lines what they move, (D + 5) and (D + 13).
Last, the whole GMG apply of the benchmark's cell (2 V-cycles, 10 levels,
Jacobi 2 + 2, device Galerkin from the fine operator at m = 10239, f64):
its milliseconds and the peak device memory it allocates above what is
held before it, with the epilogues and with every sweep and residual on the
unfused lines (``unfused_apply``, the same V-cycle written out here), and
whether the two applies are equal.  One JSON line per case, the card's name and power
limit in each.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import pysolvers_tpu_torch as pt  # noqa: E402
from pysolvers_tpu_torch.linear import gmg_grid  # noqa: E402
from pysolvers_tpu_torch.ops import GridDiaMatrix, matvec, sweep  # noqa: E402
from pysolvers_tpu_torch.sparse.device import DiaMatrix  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
OMEGA = 2.0 / 3.0


def card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out or torch.cuda.get_device_name(0)


def five_point(m: int, dtype, device) -> DiaMatrix:
    """The 5-point Laplacian stencil (4 and -1, not scaled by h^-2) on an
    m × m grid, assembled on the card."""
    n = m * m
    offsets = (-m, -1, 0, 1, m)
    col = torch.arange(n, device=device) % m
    diags = torch.full((5, n), -1.0, dtype=dtype, device=device)
    diags[2] = 4.0
    diags[0, :m] = 0.0
    diags[4, n - m:] = 0.0
    diags[1, col == 0] = 0.0
    diags[3, col == m - 1] = 0.0
    return DiaMatrix(diags, offsets,
                     torch.tensor(offsets, dtype=torch.int32, device=device),
                     (n, n))


def box9(m: int, dtype, device) -> GridDiaMatrix:
    """A 9-point box stencil with random entries on an m × m grid."""
    gen = torch.Generator(device=device).manual_seed(9)
    ldc = (m + 31) // 32 * 32
    G = torch.rand(9, m, ldc, generator=gen, dtype=dtype, device=device)
    G[:, :, m:] = 0.0
    pairs = [(a, b) for a in (-1, 0, 1) for b in (-1, 0, 1)]
    return GridDiaMatrix._make(G, pairs, (m, m))


def unfused_residual(A, x, f, dinv):
    return f - matvec(A, x)


def unfused_sweep(A, x, f, dinv):
    r = f - matvec(A, x)
    return x + OMEGA * dinv * r


def fused_residual(A, x, f, dinv):
    return sweep.residual(A, f, x)


def fused_sweep(A, x, f, dinv):
    return sweep.jacobi_sweep(A, x, f, dinv, OMEGA)


def product(A, x, f, dinv):
    return matvec(A, x)


def time_ms(fn, args, reps: int) -> float:
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn(*args)
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def run_case(name, A, reps, blocks) -> dict:
    n = A.shape[0]
    D = (len(A.offsets) if isinstance(A, DiaMatrix) else len(A.pairs))
    word = A.diags.element_size()
    gen = torch.Generator(device=A.device).manual_seed(1)
    x, f = (torch.rand(n, generator=gen, dtype=A.dtype, device=A.device)
            for _ in range(2))
    dinv = 0.2 + torch.rand(n, generator=gen, dtype=A.dtype,
                            device=A.device)
    args = (A, x, f, dinv)
    equal = {"sweep": torch.equal(fused_sweep(*args), unfused_sweep(*args)),
             "residual": torch.equal(fused_residual(*args),
                                     unfused_residual(*args))}
    ops = {"product": (product, D + 2),
           "unfused_residual": (unfused_residual, D + 5),
           "fused_residual": (fused_residual, D + 3),
           "unfused_sweep": (unfused_sweep, D + 13),
           "fused_sweep": (fused_sweep, D + 4)}
    times = {k: [] for k in ops}
    for fn, _ in ops.values():
        fn(*args)                                   # primed, untimed
    torch.cuda.synchronize()
    order = list(ops)
    for b in range(blocks):                         # in turns, both ways
        for k in (order if b % 2 == 0 else order[::-1]):
            times[k].append(time_ms(ops[k][0], args, reps))
    out = {"case": name, "n": n, "D": D, "dtype": str(A.dtype).split(".")[-1],
           "card": card(), "reps": reps, "blocks": blocks,
           "bit_equal": equal}
    for k, (_, words) in ops.items():
        ms = statistics.median(times[k])
        bound = 1e3 * words * word * n / HBM_BYTES_PER_S
        out[k] = {"ms": round(ms, 4), "words_per_row": words,
                  "bound_ms": round(bound, 4),
                  "share": round(100.0 * bound / ms, 2)}
    out["sweep_speedup"] = round(out["unfused_sweep"]["ms"]
                                 / out["fused_sweep"]["ms"], 3)
    out["residual_speedup"] = round(out["unfused_residual"]["ms"]
                                    / out["fused_residual"]["ms"], 3)
    return out


def unfused_apply(h, v, num_iters: int = 2):
    """``gmg_grid.grid_vc_apply(num_iters)`` with every Jacobi sweep and
    residual on the unfused lines: the product, then torch's passes."""

    def smooth(lev, x, f, sweeps):
        for _ in range(sweeps):
            x = unfused_sweep(lev.A_dev, x, f, lev.dinv)
        return x

    def run(k, f, x):
        if k == 0:
            return h.A0_inv.to(f.dtype) @ f
        lev = h.levels[k]
        x = smooth(lev, x, f, h.nu_pre)
        f_c = gmg_grid.grid_restrict(unfused_residual(lev.A_dev, x, f, None),
                                     h.ndim, h.ms[k], h.ms[k - 1])
        x_c = run(k - 1, f_c, torch.zeros_like(f_c))
        x = x + gmg_grid.grid_prolong(x_c, h.ndim, h.ms[k - 1], h.ms[k])
        return smooth(lev, x, f, h.nu_post)

    x = torch.zeros_like(v)
    for _ in range(num_iters):
        x = run(h.n_levels - 1, v, x)
    return x


def gmg_apply(m: int, reps: int, blocks: int) -> dict:
    """The cell's GMG apply, fused against unfused."""
    dev = torch.device("cuda")
    A = five_point(m, torch.float64, dev)
    prec = pt.GMGPreconditionerType(
        (m, m), num_iters=2, num_levels=10, nu_pre=2, nu_post=2,
        smoother="jacobi", galerkin="auto").form(None, A_dev=A, device=dev)
    v = torch.rand(m * m, dtype=torch.float64, device=dev,
                   generator=torch.Generator(device=dev).manual_seed(3))
    routes = {"fused": prec.apply_any,
              "unfused": lambda r: unfused_apply(prec.state, r)}
    out, y = {"case": "gmg_apply", "n": m * m, "card": card()}, {}
    for name, apply in routes.items():
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        y[name] = apply(v)
        torch.cuda.synchronize()
        out[name] = {"peak_above_held_gb": round(
            (torch.cuda.max_memory_allocated() - held) / 1e9, 3), "ms": []}
    out["equal"] = torch.equal(y["fused"], y["unfused"])
    del y
    for b in range(blocks):
        for name in (routes if b % 2 == 0 else list(routes)[::-1]):
            out[name]["ms"].append(time_ms(routes[name], (v,),
                                           max(1, reps // 5)))
    for name in routes:
        out[name]["ms"] = round(statistics.median(out[name]["ms"]), 3)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--blocks", type=int, default=5)
    ap.add_argument("--out", default="benchmarks/data/fused_sweep_probe.jsonl")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device: the epilogues run on the card "
                         "alone")
    dev = torch.device("cuda")
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    with open(a.out, "w") as fh:
        for dtype in (torch.float64, torch.float32):
            for name, make, m in (("k1_fine", five_point, 10239),
                                  ("k6_m5119_box9", box9, 5119)):
                A = make(m, dtype, dev)
                line = json.dumps(run_case(name, A, a.reps, a.blocks))
                print(line, flush=True)
                fh.write(line + "\n")
                del A
                torch.cuda.empty_cache()
        line = json.dumps(gmg_apply(10239, a.reps, a.blocks))
        print(line, flush=True)
        fh.write(line + "\n")


if __name__ == "__main__":
    main()

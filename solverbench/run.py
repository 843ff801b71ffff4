"""Run one cell of ``BENCHMARK.json`` once.

    python3 solverbench/run.py --workload <config>.<mix> --seed <n> \
        --seconds <s> --trace <0|1>

Prints one JSON object as the last line of standard output: ``correct``,
``attempted`` and ``failed`` (solves), ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device`` and, traced, ``breakdown``; its last key, ``checks``, holds each
number compared with its limit, which also end standard error.  Exits
non-zero without a result where the cell's CUDA devices are missing, where
the program cannot be imported, or where JAX or the JAX package was
loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# never loaded in the measured process: compared by whole top-level name
# (the program's package name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "pysolvers_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card() -> dict:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {"nvidia_smi": "not read"}
    return {"nvidia_smi": out[0] if out else "not read"}


def result(spec, cell, run, trace: bool, device: str) -> dict:
    import numpy as np
    from solverbench.lib import spec as S
    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu",
           "kind": "cpu", "count": 1,
           "memory_peak_bytes": run.memory_peak_bytes}
    if device.startswith("cuda"):
        import torch
        dev["kind"] = torch.cuda.get_device_name(0)
    out = {"correct": run.correct, "attempted": len(run.solves),
           "failed": run.failed,
           "metrics": S.read_metrics(spec, cell, "per_layer" if trace
                                     else "end_to_end", run),
           "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = {
            "device_ops": [[n, s] for n, s in run.trace.device_ops],
            "idle_gaps": [[n, s] for n, s in run.trace.idle_gaps]}
    iters = [s["iters"] for s in run.solves]
    walls = [1e3 * s["wall_s"] for s in run.solves]
    out["info"] = {"solve_ms_pct_5_25_50_75_95": (
                       list(np.percentile(walls, [5, 25, 50, 75, 95]))
                       if walls else []),
                   "setup_s": run.setup_s, "setup_parts": run.setup_parts,
                   "window_s": run.window_s,
                   "solves": len(run.solves),
                   "iters_min": min(iters, default=0),
                   "iters_max": max(iters, default=0),
                   "timers": run.timers}
    if device.startswith("cuda"):
        out["card"] = card()
    out["checks"] = run.checks
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from solverbench.lib import loop, spec as S
    spec = S.load_spec()
    cell = S.workload(spec, args.workload)
    import torch
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell["chips"]):
        print(f"solverbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run = loop.run_cell(S.config(spec, cell["config"]), S.mix(cell["traffic"]),
                        args.seed, args.seconds, bool(args.trace), "cuda",
                        T_START)
    return emit(spec, args.workload, run, bool(args.trace), "cuda")


def emit(spec, cell, run, trace: bool, device: str) -> int:
    """Print the run's result line and its checks; refuse, with no result,
    where JAX or the JAX package is loaded once everything that builds the
    result (the metric readers too) has run."""
    out = result(spec, cell, run, trace, device)
    line = json.dumps(out)
    found = forbidden_modules()
    if found:
        print(f"solverbench: the run loaded {found}; no result",
              file=sys.stderr)
        return 3
    print(line, flush=True)
    for name, c in run.checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

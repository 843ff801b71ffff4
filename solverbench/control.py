"""The control of ``correct``: the program's own float32 route of a cell,
at the cell's size, on several seeds in one process.

    python3 solverbench/control.py --workload <cell> --seeds 11,12,13 \
        --solves 12 [--dtype float32]

Each seed is one run (``loop.run_cell``) cut to ``--solves`` solves, every
one of them judged; one JSON line per seed gives the numbers compared and
their limits, and a last line the smallest of each over the seeds: the
upper readings the limits in ``configs/*.json`` sit below.  The benchmark's
runs never run it.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--solves", type=int, default=12)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from solverbench.lib import loop, spec as S
    spec = S.load_spec()
    cell = S.workload(spec, args.workload)
    lows = {}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        try:
            run = loop.run_cell(S.config(spec, cell["config"]),
                                S.mix(cell["traffic"]), seed, 1e9, False,
                                args.device, t0, dtype=args.dtype,
                                max_solves=args.solves, check_every=1)
        except Exception as e:  # a control that crashes has failed
            traceback.print_exc()
            print(json.dumps({"seed": seed, "crashed": repr(e)}), flush=True)
            continue
        for k, c in run.checks.items():
            lows[k] = min(lows.get(k, float("inf")), c["value"])
        print(json.dumps({"seed": seed, "dtype": args.dtype,
                          "correct": run.correct, "solves": len(run.solves),
                          "iters": [s["iters"] for s in run.solves],
                          "seconds": time.perf_counter() - t0,
                          "checks": run.checks}), flush=True)
    print(json.dumps({"workload": args.workload, "dtype": args.dtype,
                      "smallest": lows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""amg_setup.aggregate_s: SA's aggregation per solve, from the program's
timers over the window: "amg.device_aggregate" (the level that
galerkin="auto" aggregates first and hands to the host build) plus
"amg.aggregate" (strength and aggregates of each further host level).
None where the host build records no split ("amg.aggregate",
"amg.galerkin")."""


def read(run):
    t = run.timers
    if not run.solves or ("amg.aggregate" not in t
                          and "amg.galerkin" not in t):
        return None
    agg = t.get("amg.device_aggregate", 0.0) + t.get("amg.aggregate", 0.0)
    if agg <= 0.0:
        return None
    return agg / len(run.solves)

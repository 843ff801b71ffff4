"""amg_setup.host_s: the host's SA hierarchy build per solve, from the
program's timers over the window: "amg.host_hierarchy" (host SA) plus
"amg.device_aggregate" (the aggregation that galerkin="auto" tries
first and hands to the host build)."""


def read(run):
    t = run.timers.get("amg.host_hierarchy", 0.0) + run.timers.get(
        "amg.device_aggregate", 0.0)
    if not run.solves or t <= 0.0:
        return None
    return t / len(run.solves)

"""amg_setup.lower_s: lowering the host hierarchy onto the device per
solve (uploads, formats, the coarse inverse), from the program's timer
"amg.device_lower" over the window.  It does not synchronise: an
asynchronous tail of its uploads falls into the solve."""


def read(run):
    t = run.timers.get("amg.device_lower", 0.0)
    if not run.solves or t <= 0.0:
        return None
    return t / len(run.solves)

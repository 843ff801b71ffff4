"""amg_setup.native_galerkin_share: the share of the window's host SA
levels whose smoothed prolongator came from the native one-pass build
rather than the numpy route, in %: the program's counters
"amg.native_galerkin_levels" over "amg.galerkin_levels" (always on).
None where no level is counted, as in a program without them."""


def read(run):
    from pysolvers_tpu_torch.utils.timing import Timer
    levels = Timer._counts.get("amg.galerkin_levels", 0)
    if levels <= 0:
        return None
    return 100.0 * Timer._counts.get("amg.native_galerkin_levels", 0) / levels

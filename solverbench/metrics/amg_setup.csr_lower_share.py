"""amg_setup.csr_lower_share: the share of the window's AMG hierarchy
matrices lowered straight to K2's layout rather than packed as BWS, in %:
the program's counters "amg.csr_lowerings" over "amg.csr_lowerings" plus
"amg.bws_packs" (always on).  None where neither counts, as in a program
without them."""


def read(run):
    from pysolvers_tpu_torch.utils.timing import Timer
    lowered = Timer._counts.get("amg.csr_lowerings", 0)
    total = lowered + Timer._counts.get("amg.bws_packs", 0)
    if total <= 0:
        return None
    return 100.0 * lowered / total

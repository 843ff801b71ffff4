"""precond.graph_replay_share: the share of the window's AMG preconditioner
applies whose result came from a CUDA graph launch, in %: the program's
counters "amg.graph_replays" over "amg.applies" (always on).  None where
the program keeps no such counter."""


def read(run):
    from pysolvers_tpu_torch.utils.timing import Timer
    applies = Timer._counts.get("amg.applies", 0)
    if applies <= 0:
        return None
    return 100.0 * Timer._counts.get("amg.graph_replays", 0) / applies

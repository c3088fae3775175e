"""The launch counters of the port's device work, by name: every kernel
wrapper's (``kernels.launch_counters``) and, beside them, every collective
of a row-sharded solve (``parallel.comm.collective_counters``).  Each
counter's ``launches`` goes up by one where its work is issued; a CUDA
graph's capture records how many launches of each counter it holds and its
replays add them (``solvers/graphs.py``), so the graphs and the reports read
both kinds here."""


def all_counters() -> dict:
    """The kernels' launch counters and the collectives' counters, by
    name."""
    from ..kernels import launch_counters
    from ..parallel.comm import collective_counters

    return {**launch_counters(), **collective_counters()}

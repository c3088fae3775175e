"""Experiments: solver wrappers, SingleSolve, Evolve, TimedSolve, the error
sweep, reporting, scaling, the batched solve and the command line."""

from . import error_sweep, report, wrappers  # noqa: F401
from .evolve import deviation_plotter, evolve  # noqa: F401
from .single_solve import single_solve  # noqa: F401
from .timed_solve import time_cgmres, timed_solve  # noqa: F401
from . import scaling  # noqa: F401
from . import batched  # noqa: F401

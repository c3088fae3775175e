"""Utilities of the port: checkpointing of long evolutions, profiling
ranges, the launch counters of the kernels and the collectives
(``counters.py``), the native host kernels (``native.py``) and a system
or a preconditioner in another storage dtype (``cast.py``)."""

from . import cast, checkpoint, counters, native, profiling  # noqa: F401

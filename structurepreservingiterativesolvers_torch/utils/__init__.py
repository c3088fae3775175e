"""Utilities of the port: checkpointing of long evolutions, profiling
ranges, the launch counters of the kernels and the collectives
(``counters.py``), and the native host kernels (``native.py``)."""

from . import checkpoint, counters, native, profiling  # noqa: F401

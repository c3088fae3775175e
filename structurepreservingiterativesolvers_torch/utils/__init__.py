"""Utilities of the port: checkpointing of long evolutions, profiling
ranges, and the native host kernels (``native.py``)."""

"""Experiments: solver wrappers, SingleSolve and the command line."""

"""Utilities of the port: checkpointing of long evolutions."""

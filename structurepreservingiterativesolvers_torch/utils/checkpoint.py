"""Checkpoint and resume for long evolutions.

The port of the JAX package's ``utils/checkpoint.py``: the evolve loop writes
its state (the solution vector, the step index and the drift series) to a
numpy ``.npz`` file every few steps and resumes from it.  The vector is
stored on the host; ``evolve`` moves it back to its device.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def save_state(path: str, step: int, z, series: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if isinstance(z, torch.Tensor):
        z = z.detach().cpu().numpy()
    np.savez(
        path,
        step=step,
        z=np.asarray(z),
        **{f"series_{k}": np.asarray(v) for k, v in series.items()},
    )


def load_state(path: str):
    """``(step, z, series)`` from a checkpoint, or None where there is none."""
    if not os.path.exists(path):
        return None
    with np.load(path) as f:
        step = int(f["step"])
        z = f["z"]
        series = {
            k[len("series_"):]: f[k].tolist()
            for k in f.files if k.startswith("series_")
        }
    return step, z, series

"""A system or a preconditioner in another storage dtype.

``astype(obj, dtype)`` returns a copy of a model's system, an operator or a
preconditioner whose floating tensors are in ``dtype``: an operator through
its own ``astype`` (DIA, ELL, BSR, Stencil; a copy without the original's
plans and launches), a dataclass field by field, a tuple or a list element
by element; integer and boolean tensors, numbers, numpy arrays and scipy
matrices are kept.  Each model and each preconditioner of the port builds
its arrays in f64 on the host and casts them to the device dtype once
(``torch.as_tensor(..., dtype=)``), so the cast of an f64 build is the f32
build, bit for bit: a caller with an f64 system assembled (lkdvRK's RAS
inverses, heat P2's assembly and greedy hierarchy take tens of seconds on
the host at the chip's sizes) takes its f32 twin without building again.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch


def astype(obj, dtype: torch.dtype):
    if isinstance(obj, torch.Tensor):
        return obj.to(dtype) if obj.is_floating_point() else obj
    if isinstance(obj, (np.ndarray, np.generic)) or sp.issparse(obj):
        return obj
    if hasattr(obj, "astype") and not isinstance(obj, type):
        return obj.astype(dtype)
    if isinstance(obj, (tuple, list)):
        return type(obj)(astype(v, dtype) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        changes = {f.name: astype(getattr(obj, f.name), dtype)
                   for f in dataclasses.fields(obj) if f.init}
        return dataclasses.replace(obj, **changes)
    return obj

"""Multi-process distribution (the port of the JAX package's
``parallel/distributed.py``): the process group, global meshes, and the
local spawner.

One process drives one device (SPMD).  Each process calls
``init_distributed``, builds the same global mesh and runs the same solver;
the collectives are NCCL between CUDA devices and gloo between CPU
processes.  Ranks are host-major when each host's processes take
consecutive ranks (``spawn_local`` numbers them so), so a 1-D row sharding
keeps consecutive row blocks on one host and the halo exchange crosses
hosts only at the host boundaries.  Nothing on a machine tells a program of
a cluster: the coordinator's address, the number of processes and this
process's id come from the arguments or the ``SPIS_*`` variables.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import tempfile
from typing import Optional

import numpy as np
import torch

from .comm import ROWS
from .mesh import make_mesh

HOSTS = "hosts"
CHIPS = "chips"


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: Optional[str] = None,
) -> tuple:
    """Initialise ``torch.distributed`` for this process; returns
    ``(process_id, num_processes)``.

    Arguments fall back to the ``SPIS_COORDINATOR`` (``host:port``, a
    ``TCPStore`` that process 0 serves, or ``file://path``, a ``FileStore``)
    / ``SPIS_NUM_PROCESSES`` / ``SPIS_PROCESS_ID`` / ``SPIS_DEVICE``
    variables; with none, a world of one process on an in-memory store.
    ``device``: ``"cuda"`` (NCCL; this process's card is the visible one of
    its local rank, ``SPIS_LOCAL_RANK``, else the process id modulo the
    cards) or ``"cpu"`` (gloo); the card by default, and without a card
    ``"cuda"`` raises: the CPU runs only where the caller asks for it.
    Idempotent: calling again after a successful init is a no-op."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    coordinator = coordinator or os.environ.get("SPIS_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("SPIS_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("SPIS_PROCESS_ID", "0"))
    device = device or os.environ.get("SPIS_DEVICE") or "cuda"
    if num_processes > 1 and not coordinator:
        raise ValueError(f"{num_processes} processes need a coordinator "
                         "(SPIS_COORDINATOR: host:port or file://path)")
    if num_processes == 1 and not coordinator:
        store = dist.HashStore()
    elif coordinator.startswith("file://"):
        store = dist.FileStore(coordinator[len("file://"):], num_processes)
    else:
        host, port = coordinator.rsplit(":", 1)
        store = dist.TCPStore(host, int(port), num_processes,
                              is_master=process_id == 0)
    kw = {}
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' and no CUDA device is present; "
                               "pass device='cpu' (SPIS_DEVICE=cpu) for gloo "
                               "ranks on the CPU")
        local = int(os.environ.get("SPIS_LOCAL_RANK",
                                   process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        # no flight recorder: it records each collective's call stack, which
        # the host loop's many small all-reduces pay for
        os.environ.setdefault("TORCH_NCCL_TRACE_BUFFER_SIZE", "0")
        os.environ.setdefault("TORCH_FR_BUFFER_SIZE", "0")
        kw["device_id"] = torch.device("cuda", local)
        backend = "nccl"
    elif device == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device={device!r}: use 'cuda' or 'cpu'")
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes, **kw)
    return dist.get_rank(), dist.get_world_size()


def global_mesh(axis: str = ROWS):
    """The 1-D mesh over every process of the job, host-major (ranks in
    order: each host's processes take consecutive ranks)."""
    if axis != ROWS:
        raise ValueError(f"the port's mesh axis is {ROWS!r}, got {axis!r}")
    return make_mesh()


@dataclasses.dataclass(frozen=True)
class HostChipMesh:
    """The 2-D (hosts, chips) factorisation of the job's ranks:
    ``devices[h, c]`` is the rank of chip c of host h."""

    devices: np.ndarray
    axis_names: tuple = (HOSTS, CHIPS)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))


def host_chip_mesh() -> HostChipMesh:
    """The (hosts, chips) mesh, from the local world size (the processes of
    a host: ``SPIS_LOCAL_PROCESSES``, else every process on one host)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        init_distributed()
    size = dist.get_world_size()
    local = int(os.environ.get("SPIS_LOCAL_PROCESSES", size))
    if size % local:
        raise ValueError(f"{size} processes do not split into hosts of {local}")
    return HostChipMesh(np.arange(size).reshape(size // local, local))


def is_coordinator() -> bool:
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def spawn_local(num_processes: int, argv: list, env_extra: Optional[dict] = None,
                port: Optional[int] = None, timeout: float = 600.0,
                device: str = "cuda"):
    """Spawn ``num_processes`` copies of the port's CLI as local processes
    forming one distributed job, one device per process: with
    ``device="cuda"`` (the default) process p sees only card p (``CUDA_VISIBLE_DEVICES``;
    there must be that many), with ``"cpu"`` each is a gloo rank.  The
    processes meet at a ``FileStore`` in a fresh temporary directory, or at
    ``localhost:port`` where ``port`` is given.  Returns the list of
    (returncode, output) per process; a process that outlives ``timeout``
    is killed."""
    if device == "cuda" and num_processes > torch.cuda.device_count():
        raise ValueError(f"{num_processes} processes of one card each, "
                         f"{torch.cuda.device_count()} cards")
    tmp = tempfile.mkdtemp(prefix="spis_store_")
    coordinator = (f"localhost:{port}" if port is not None
                   else "file://" + os.path.join(tmp, "store"))
    procs = []
    for pid in range(num_processes):
        env = dict(os.environ)
        env.update(env_extra or {})
        env["SPIS_COORDINATOR"] = coordinator
        env["SPIS_NUM_PROCESSES"] = str(num_processes)
        env["SPIS_PROCESS_ID"] = str(pid)
        env["SPIS_DEVICE"] = device
        env["SPIS_LOCAL_PROCESSES"] = str(num_processes)
        if device == "cuda":
            visible = os.environ.get("CUDA_VISIBLE_DEVICES")
            cards = (visible.split(",") if visible
                     else [str(i) for i in range(torch.cuda.device_count())])
            env["CUDA_VISIBLE_DEVICES"] = cards[pid]
            env["SPIS_LOCAL_RANK"] = "0"
        else:
            env.setdefault("OMP_NUM_THREADS", "1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "structurepreservingiterativesolvers_torch"]
            + list(argv),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env))
    outs = []
    try:
        for p in procs:
            try:
                out, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        store = os.path.join(tmp, "store")
        if os.path.exists(store):
            os.remove(store)
        os.rmdir(tmp)
    return outs

"""CUDA graphs for the device-resident solver core (port-only).

The JAX package runs its CGMRES core as one jitted program: a
``lax.while_loop`` whose gate, endgame and latch are ``lax.cond``s
(``solvers/cgmres.py:147`` there).  The port cuts that program into steps.
Each step is a Python function of static shapes (the Arnoldi index is a
Python constant in it) that reads and writes only tensors allocated before
it runs, the core's *static buffers*; a host loop picks the next step from
a few flags the steps write.  ``GraphRunner`` runs the steps:

* on the CPU, and on the card where the caller asks for it with
  ``capture=False``, it calls the function: the eager device core;
* on the card it captures the function into a ``torch.cuda.CUDAGraph`` the
  first time its key runs, and replays that graph from then on.  A capture
  or a replay that fails raises; nothing falls back to running eagerly.

What a function does the first time it meets the card (building a kernel,
a DIA's live plan and resolved launch, the cuBLAS handles, the fused CGS2
kernel's shared-memory attribute) must not happen inside a capture: the
caller does it in ``warmup``, on scratch tensors, before the first capture.

The kernel wrappers count their launches in Python, which a replay does not
run.  So a capture records how many launches of each kernel it holds and
puts the counters back; each replay then adds those numbers to them
(``utils.counters.all_counters``: the kernels' and the collectives').  The
warm-up's launches, on scratch tensors, are put back too: the counters
count the replays' launches only.

Every graph of one runner allocates from one memory pool.  The steps leave
their results in the static buffers only, so no tensor of the pool outlives
the capture that allocated it, and the graphs may share the pool in any
order of replay.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Hashable, Optional

import torch

from ..utils.counters import all_counters
from ..utils.profiling import span


class GraphRunner:
    """Runs the steps of a device core on ``device``, captured as CUDA
    graphs on the card unless ``capture=False``.

    ``time_capture`` sums the seconds spent capturing; ``captures`` and
    ``replays`` count graphs made and replayed, ``replayed`` the replays of
    each key."""

    def __init__(self, device, capture: Optional[bool] = None):
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        self.capture = cuda if capture is None else bool(capture)
        if self.capture and not cuda:
            raise ValueError(f"CUDA graphs need a CUDA device, got {self.device}")
        self.graphs: Dict[Hashable, tuple] = {}
        self.replayed: Dict[Hashable, int] = {}
        self.time_capture = 0.0
        self.captures = self.replays = 0
        if self.capture:
            self.stream = torch.cuda.Stream(self.device)
            self.pool = torch.cuda.graph_pool_handle()

    def warmup(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` once, eagerly, on the stream the captures use: the
        first-use work of what the steps call, on scratch tensors; its
        kernel launches are not counted.  Nothing to do where nothing is
        captured."""
        if not self.capture:
            return
        counters = all_counters().values()
        before = [c.launches for c in counters]
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            fn()
        current.wait_stream(self.stream)
        for counter, n0 in zip(counters, before):
            counter.launches = n0

    def run(self, key: Hashable, fn: Callable[[], None]) -> None:
        """Run the step ``fn``, known by ``key``: call it, or replay its
        graph (captured now if ``key`` is new)."""
        if not self.capture:
            fn()
            return
        entry = self.graphs.get(key)
        if entry is None:
            entry = self.graphs[key] = self._capture(fn)
        graph, counts = entry
        with span(f"replay {key}", self.device):
            graph.replay()
        for counter, n in counts:
            counter.launches += n
        self.replays += 1
        self.replayed[key] = self.replayed.get(key, 0) + 1

    def launches(self) -> Dict[str, Dict[str, int]]:
        """Kernel launches per replay of each kind of graph (a key's first
        part: ``arnoldi``, ``advance``, ...), by counter name
        (``utils.counters.all_counters``), the most over the graphs of a
        kind."""
        names = {id(fn): name for name, fn in all_counters().items()}
        out: Dict[str, Dict[str, int]] = {}
        for key, (_, counts) in self.graphs.items():
            per = out.setdefault(key if isinstance(key, str) else key[0], {})
            for counter, n in counts:
                name = names[id(counter)]
                per[name] = max(per.get(name, 0), n)
        return out

    def replayed_launches(self) -> Dict[str, int]:
        """The kernel launches of all replays so far, by counter name: each
        graph's captured launches times its replays."""
        names = {id(fn): name for name, fn in all_counters().items()}
        out: Dict[str, int] = {}
        for key, (_, counts) in self.graphs.items():
            for counter, n in counts:
                name = names[id(counter)]
                out[name] = out.get(name, 0) + n * self.replayed.get(key, 0)
        return out

    def read(self, flags: torch.Tensor) -> list:
        """The host's copy of a small tensor of flags: one device-to-host
        copy, which waits for the work queued before it."""
        with span("flag read", self.device):
            return flags.tolist()

    def _capture(self, fn):
        counters = all_counters().values()
        before = [c.launches for c in counters]
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            graph.capture_begin(pool=self.pool,
                                capture_error_mode="thread_local")
            try:
                fn()
            except BaseException:
                # end the broken capture, then report what broke it
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass
                raise
            graph.capture_end()
        counts = []
        for counter, n0 in zip(counters, before):
            if counter.launches != n0:
                counts.append((counter, counter.launches - n0))
                counter.launches = n0
        self.time_capture += time.perf_counter() - t0
        self.captures += 1
        return graph, tuple(counts)

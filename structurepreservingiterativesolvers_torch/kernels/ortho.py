"""The middle pair of CGS2 in one read of the basis: the hand-written Hopper
kernel, its launch plan, its plain PyTorch twin, and the wrapper that picks
between them by the device of the tensors.

Given the active Krylov basis ``Q`` (m rows of length n), a vector ``w`` and
its first projection ``h = Q w``::

    w1 = w − hᵀQ,    u2 = Q w1

The kernel (``csrc/ortho_fused.cu``) replaces the JAX package's
``ops/pallas_ortho.py::fused_update_matvec``; its source says what bounds it
and how it is laid out: a persistent grid whose blocks take the column
tiles in turn, a ring of shared-memory stages filled by TMA bulk copies,
and the blocks' partial sums of u2 added in block order by the last block
to finish, in the same launch.  ``ortho_plan`` gives the
launch from the shapes alone.  The JAX package switches its kernel on with
the environment variable ``SPIS_ORTHO_ENGINE=pallas`` (f32 only, a gate
whose size threshold ``MIN_N`` is never read); the port has no gate: the
caller asks for it explicitly (``ortho="cgs2_fused"`` in the solvers).

The wrapper takes the plain version for CPU tensors only.  A CUDA tensor is
launched through the kernel, or the wrapper raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Tuple

import torch

from . import count_f32

MAX_ROWS = 128  # ORTHO_MAX_ROWS in csrc/ortho_fused.cu: a basis of k ≤ 127
# the SMs of an H100 SXM, the plan's grid: one block an SM
SMS = 132
# csrc/ortho_fused.cu: a block of 8 consumer warps and a producer warp; at
# most 8 stages; the shared memory a block may use (227 KB); the bytes
# before the stages: barriers, h, then two rows of w1
CONSUMER_WARPS = 8
THREADS = 32 * (CONSUMER_WARPS + 1)
MAX_STAGES = 8
SMEM_MAX = 232448
W1_OFFSET = 256 + 8 * MAX_ROWS
# the plan: a tile row of at most 8 KB, and of 2 KB or more unless 3
# stages of it do not fit or n gives fewer than half the SMs a tile (at
# small n a block's time is its tiles' latency); a stage of at most 48 KB
# where the rows allow; at least 3 stages, and as many more as keep 64 KB
# in flight behind the one the consumers read
MIN_STAGES = 3
ROW_BYTES_MAX = 8192
ROW_BYTES_MIN = 2048
STAGE_BYTES = 48 * 1024
IN_FLIGHT = 64 * 1024
MIN_COLS = 32  # a warp's lanes


class OrthoPlan(NamedTuple):
    """The kernel's launch: ``bn`` columns a tile, ``stages`` in the ring,
    ``grid`` blocks, ``smem`` dynamic shared bytes a block, ``ntiles`` the
    BN-wide pieces of n (the grid's bound)."""

    bn: int
    stages: int
    grid: int
    smem: int
    ntiles: int


def _head_bytes(bn: int, itemsize: int) -> int:
    return -(-(W1_OFFSET + 2 * bn * itemsize) // 128) * 128


def _stage_bytes(m: int, bn: int, itemsize: int) -> int:
    # m rows of Q and one of w, each padded by 16 bytes for its offset in
    # its aligned superset
    return (m + 1) * (bn * itemsize + 16)


def smem_bytes(m: int, bn: int, stages: int, itemsize: int) -> int:
    """The shared bytes of a launch (``ortho_smem_bytes`` in the source)."""
    return _head_bytes(bn, itemsize) + stages * _stage_bytes(m, bn, itemsize)


@functools.lru_cache(maxsize=None)
def ortho_plan(m: int, n: int, dtype: torch.dtype) -> OrthoPlan:
    """The launch for an (m, n) basis of ``dtype``, from these numbers alone
    (no host sync, no trial launch): the widest tile of a power of two
    columns, from 8 KB rows down, whose stage stays within ``STAGE_BYTES``
    (never below 2 KB rows for that), with ``MIN_STAGES`` stages in 227 KB,
    and narrowed (to 32 columns at the least) until the n columns give at
    least half the SMs a tile; then ``MIN_STAGES`` stages, or more where a
    stage is small, up to ``IN_FLIGHT`` bytes behind the one in use (at
    most ``MAX_STAGES``, and as many as fit); a grid of one block an SM, at
    most one a BN-wide piece of n."""
    if not 1 <= m <= MAX_ROWS or n < 1:
        raise ValueError(f"no plan for m={m}, n={n}")
    size = torch.empty((), dtype=dtype).element_size()
    bn = ROW_BYTES_MAX // size
    while bn > MIN_COLS and (
            smem_bytes(m, bn, MIN_STAGES, size) > SMEM_MAX
            or (_stage_bytes(m, bn, size) > STAGE_BYTES
                and bn * size > ROW_BYTES_MIN)
            or 2 * -(-n // bn) < SMS):
        bn //= 2
    stage = _stage_bytes(m, bn, size)
    stages = min(MAX_STAGES, (SMEM_MAX - _head_bytes(bn, size)) // stage,
                 max(MIN_STAGES, 1 + -(-IN_FLIGHT // stage)))
    ntiles = -(-n // bn)
    grid = min(SMS, ntiles)
    return OrthoPlan(bn, stages, grid, smem_bytes(m, bn, stages, size), ntiles)


def block_tiles(plan: OrthoPlan, n: int, b: int) -> List[Tuple[int, int]]:
    """Block b's tiles in order, as (first column, columns): the tiles b,
    b + G, ... of ``bn`` columns from 0, the last one ragged."""
    return [(c0, min(plan.bn, n - c0))
            for c0 in range(b * plan.bn, n, plan.grid * plan.bn)]


def row_segment(addr: int, cols: int, itemsize: int) -> Tuple[int, int, int]:
    """The bulk copy of a row segment of ``cols`` elements at byte address
    ``addr``: its 16-byte aligned superset's start and bytes, and the
    segment's offset in it, in elements."""
    lo = addr & ~15
    return lo, ((addr + cols * itemsize + 15) & ~15) - lo, (addr - lo) // itemsize


def tile_bulk(c0: int, cols: int, m: int, n: int, ld: int, q_addr: int,
              w_addr: int, itemsize: int) -> bool:
    """Whether the kernel loads the tile of ``cols`` columns from ``c0`` by
    bulk copies: the aligned supersets of its row segments stay inside Q
    and w (else the producer warp loads it with plain loads)."""
    q_end = q_addr + ((m - 1) * ld + n) * itemsize
    w_end = w_addr + n * itemsize
    q_lo, _, _ = row_segment(q_addr + c0 * itemsize, cols, itemsize)
    last = q_addr + ((m - 1) * ld + c0) * itemsize
    lo, nbytes, _ = row_segment(last, cols, itemsize)
    w_lo, w_bytes, _ = row_segment(w_addr + c0 * itemsize, cols, itemsize)
    return (n * itemsize >= 16 and q_lo >= q_addr and lo + nbytes <= q_end
            and w_lo >= w_addr and w_lo + w_bytes <= w_end)


def fused_update_matvec_torch(Q: torch.Tensor, w: torch.Tensor,
                              h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version, and the definition: ``w1 = w − h @ Q``, then
    ``u2 = Q @ w1`` (two reads of Q)."""
    w1 = w - h @ Q
    return w1, Q @ w1


def _check(Q: torch.Tensor, w: torch.Tensor, h: torch.Tensor) -> None:
    if not (Q.device == w.device == h.device):
        raise ValueError(
            f"Q on {Q.device}, w on {w.device}, h on {h.device}: one device")
    if Q.dtype not in (torch.float64, torch.float32) or not (
            Q.dtype == w.dtype == h.dtype):
        raise TypeError(
            f"the fused CGS2 kernel takes f64 or f32 with Q, w and h alike; "
            f"got {Q.dtype}, {w.dtype}, {h.dtype}")
    if Q.dim() != 2 or w.dim() != 1 or h.dim() != 1 \
            or Q.shape != (h.shape[0], w.shape[0]):
        raise ValueError(
            f"shapes: Q {tuple(Q.shape)} must be (m, n) with w "
            f"{tuple(w.shape)} (n,) and h {tuple(h.shape)} (m,)")
    if not 1 <= Q.shape[0] <= MAX_ROWS:
        raise ValueError(f"{Q.shape[0]} basis rows: the kernel takes 1 to "
                         f"{MAX_ROWS}")
    if not (Q.is_contiguous() and w.is_contiguous() and h.is_contiguous()):
        raise ValueError("the fused CGS2 kernel needs contiguous Q, w and h")


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    """The C entry point for ``dtype``, built and loaded on first use."""
    from .build import load

    lib = load("ortho_fused.cu")
    fn = (lib.fused_update_matvec_f64 if dtype == torch.float64
          else lib.fused_update_matvec_f32)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# the blocks' partial sums of u2 (``SMS`` x ``MAX_ROWS``) and the ticket
# counter, by (device, dtype): allocated on a device's first launch, never
# per call, and never inside a CUDA-graph capture (the device core's warm-up
# launches first); the last block of each launch leaves the counter at 0
_SCRATCH: dict = {}


def _scratch(device: torch.device, dtype: torch.dtype):
    key = (device, dtype)
    if key not in _SCRATCH:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "kernel #5's scratch is allocated on its first launch on a "
                "device, which must come before any graph capture")
        _SCRATCH[key] = (
            torch.empty(SMS * MAX_ROWS, dtype=dtype, device=device),
            torch.zeros(1, dtype=torch.int32, device=device))
    return _SCRATCH[key]


def fused_update_matvec_cuda(Q: torch.Tensor, w: torch.Tensor,
                             h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel (one launch: its blocks' partials are added by the
    last block) on PyTorch's current stream; does not synchronise."""
    if Q.device.type != "cuda":
        raise ValueError(
            f"fused_update_matvec_cuda needs CUDA tensors, got {Q.device}")
    _check(Q, w, h)
    m, n = Q.shape
    plan = ortho_plan(m, n, Q.dtype)
    partial, counter = _scratch(Q.device, Q.dtype)
    w1 = torch.empty_like(w)
    u2 = torch.empty_like(h)
    stream = torch.cuda.current_stream(Q.device).cuda_stream
    # contiguous rows: the row stride is n
    err = _entry(Q.dtype)(Q.data_ptr(), n, w.data_ptr(), h.data_ptr(),
                          w1.data_ptr(), u2.data_ptr(), partial.data_ptr(),
                          partial.numel(), counter.data_ptr(), m, n, plan.bn,
                          plan.stages, plan.grid, plan.smem,
                          Q.device.index or 0, stream)
    if err != 0:
        raise RuntimeError(
            f"fused_update_matvec kernel launch failed: cudaError {err}")
    fused_update_matvec_cuda.launches += 1
    count_f32("fused_update_matvec", Q.dtype)
    return w1, u2


fused_update_matvec_cuda.launches = 0  # kernel launches; reset it to count a run


def fused_update_matvec(Q: torch.Tensor, w: torch.Tensor,
                        h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The wrapper: ``(w − hᵀQ, Q (w − hᵀQ))``.  CUDA tensors go through the
    kernel, CPU tensors through the plain version; both refuse what the
    kernel does not take."""
    if Q.device.type == "cuda":
        return fused_update_matvec_cuda(Q, w, h)
    _check(Q, w, h)
    if Q.device.type == "cpu":
        return fused_update_matvec_torch(Q, w, h)
    raise ValueError(f"no fused CGS2 update for device {Q.device}")

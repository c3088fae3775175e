"""DIA SpMV: the hand-written Hopper kernel, its plain PyTorch twin, and the
wrapper that picks between them by the device of the tensors.

``y[i] = sum_d data[d, i] * x[i + offsets[d]]``, with the column taken mod n
when ``wrap`` is true and treated as a structural zero outside ``[0, n)``
otherwise.  The kernel (``csrc/dia_spmv.cu``) replaces the JAX package's
``ops/pallas_spmv.py::dia_spmv_pallas``; its source says what bounds it and
how it is laid out.

The kernel reads only the live segments of the diagonals: a live plan
(``live_plan``) holds one 64-bit word per chunk of ``chunk`` rows, with bit d
set where ``data[d]`` holds a non-zero in that chunk.  ``ops/sparse.py::DIA``
builds its plan once, on its first product on the card, and keeps it.  Two
designs of one kernel, each counting its own launches:

* live (``dia_spmv_live_cuda``): with a plan; a diagonal that is exactly 0
  over a chunk is not read there;
* dense (``dia_spmv_dense_cuda``): without one, every diagonal over every
  row, as the first design of this kernel read them.

``DIA @ x`` launches the live design only where its plan skips at least
``LIVE_MIN_SKIP`` of the coefficients (``LivePlan.pays``), and the dense one
elsewhere: the live design reads a chunk's word before its coefficients,
which costs more than a plan that skips little saves.

For finite x the two give the same bits (up to the sign of a zero).  An Inf
or NaN of x that only skipped zero coefficients read does not reach y in the
live design, as in a CSR product; the dense design and the plain twin
multiply every diagonal, so there it spreads.

``dia_launch`` resolves an operator's design and arguments once, and
``ops/sparse.py::DIA`` keeps them, so a product costs the host the check of
x and one C call (``launch``).  The wrapper takes the plain version for CPU
tensors only.  A CUDA tensor is launched through the kernel, or the wrapper
raises: there is no fallback.

The product with a block of vectors, ``Y = A X`` for an (n, B) X
(``dia_spmm``), is a kernel of its own (``csrc/dia_spmm.cu``), the
counterpart of the JAX package's ``dia_spmv_pallas`` under ``jax.vmap``,
through the same live plan and the same resolved launch (``launch_many``).
``spmm_plan`` picks one of its designs from the shapes alone:

* tile (large n): a tile of 4 or 8 vectors in registers, one diagonal at a
  time, the blocks taken in strips of the operator (``spmm_strip``);
* spread (small n, and one vector): four diagonals in flight, the vectors
  split over a grid axis so that the card is covered.

``spmm_design`` launches either, whatever the plan would pick.  Each launch
counts in ``dia_spmm_cuda``, in its plan's counter (``dia_spmm_live_cuda``
or ``dia_spmm_dense_cuda``) and in its design's (``dia_spmm_tile_cuda``,
``dia_spmm_spread_cuda``).  Column b of its product is kernel #1's product
of column b in both designs.  Its plain twin is ``dia_spmm_torch``.

The mixed form (``dia_spmv_mixed``) is kernel #1 on f32 data and x with f64
products and sums, and an f64 y: the f32 storage mode's constraint values
and f64 reductions (``ops/sparse.py::matvec_f64``), the counterpart of the
JAX package's double-f32 ``ops/dd.py::spmv_dia``.  It launches in the
operator's live or dense design through the same resolved launch, and
counts in ``dia_spmv_mixed_cuda`` alone.  Its plain twin
(``dia_spmv_mixed_torch``) upcasts, then takes the f64 product.  On a
row-sharded operator it takes the shard's windowed launch
(``window_launch``, f32 window and data, f64 y; ``MIXED_WINDOW`` counts it
too), whose plain twin is ``dia_spmv_window_mixed_torch``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple, Optional, Sequence

import torch

from . import MIXED_WINDOW, UPCAST, count_f32

MAX_DIAGS = 64  # DIA_MAX_DIAGS in csrc/dia_spmv.cu; from_scipy caps ndiag here
# the entry points' ``wrap`` argument of a windowed launch (DIA_EDGE_WINDOW in
# csrc/dia_row.cuh; 0 and 1 are the zero-filled and the wrapped operator)
EDGE_WINDOW = 2
# rows of a chunk of the live plan, measured on an H100 at the swe M=512
# operator (chip_smoke.py): at least a warp's rows, 32 x (16 / itemsize)
LIVE_CHUNK = 64
# the least share of the coefficients a plan must skip for the live design to
# run: at heat M=1024's A, live in all but 0.2% of its segments, the live
# design took 0.0290 ms and the dense one 0.0271-0.0272 ms on an H100
# (chip_smoke.py, L2 flushed), 7% more for the plan's word; at swe M=512,
# which skips 69%, it took 0.0227 ms and the dense one 0.0505-0.0508 ms
LIVE_MIN_SKIP = 0.1


# streaming multiprocessors of an H100 SXM: below this many blocks of one
# vector's rows the plan spreads the vectors over the grid
SMS = 132
# threads of a block of the batched kernel (DIA_THREADS in csrc/dia_row.cuh)
SPMM_THREADS = 256
# the designs of the batched kernel (csrc/dia_spmm.cu): the diagonals each
# has in flight (``depth``) and the tiles it is built for
DEPTHS = {"tile": 1, "spread": 4}
TILES = {"tile": (4, 8), "spread": (1, 2)}
DESIGNS = tuple(DEPTHS)


class SpmmPlan(NamedTuple):
    """A launch of the batched kernel: the design, the vectors a thread
    sums at a time (``tile``), the vectors of a block column (``split``:
    the grid's second axis has ceil(B / split) columns), the diagonals in
    flight (``depth``) and the rows of a strip (``strip``,
    ``spmm_strip``)."""

    design: str
    tile: int
    split: int
    depth: int
    strip: int


def _grid_blocks(n: int, dtype: torch.dtype) -> int:
    """Blocks of the kernel's grid that one vector's n rows fill."""
    return -(-n // (SPMM_THREADS // 32 * warp_rows(dtype)))


def spmm_strip(n: int, offsets: Sequence[int], dtype: torch.dtype) -> int:
    """The rows of a strip of the batched kernel's block order: where the
    far offsets (|off| >= n / 8) couple rows about n / k apart for a whole
    k >= 2 (swe's three fields of M^2 rows), n / k, so that the blocks that
    run together take rows from every strip and read x from L2 where the
    other strips' blocks have just read it; else n (one strip).  A strip
    holds whole warps' rows."""
    far = [abs(int(o)) for o in offsets if 8 * abs(int(o)) >= n]
    if not far:
        return n
    k = round(n / min(far))
    if k < 2 or n % k or (n // k) % warp_rows(dtype):
        return n
    return n // k


def spmm_design(design: str, n: int, nvec: int,
                dtype: torch.dtype = torch.float64,
                strip: Optional[int] = None) -> SpmmPlan:
    """The launch of ``design`` at these shapes, whether or not the plan
    would pick it, with its least tile that holds the block (else its
    largest): spread splits the vectors until the grid covers the card
    (down to one vector a block column), the others take every vector in
    one block column.  ``strip``: ``spmm_strip``'s, n by default."""
    if design not in DESIGNS:
        raise ValueError(f"no batched design {design!r}; one of "
                         f"{DESIGNS}")
    strip = n if strip is None else strip
    tile = next((t for t in TILES[design] if t >= nvec), TILES[design][-1])
    split = nvec
    if design == "spread":
        blocks = _grid_blocks(n, dtype)
        tile = next((t for t in reversed(TILES["spread"])
                     if t <= tile and blocks * -(-nvec // t) >= SMS), 1)
        split = tile
    return SpmmPlan(design, tile, split, DEPTHS[design], strip)


@functools.lru_cache(maxsize=None)
def spmm_plan(n: int, nvec: int, dtype: torch.dtype = torch.float64,
              strip: Optional[int] = None) -> SpmmPlan:
    """The batched kernel's launch for an (n, nvec) block of an operator
    whose strip is ``strip`` (``spmm_strip``), from these numbers alone (no
    host sync, no trial launch): spread where one vector's rows give the
    kernel's grid fewer than ``SMS`` blocks (lkdvRK's and lkdv's
    operators) and for one vector (kernel #1's schedule), tile elsewhere
    (swe's and heat's operators), with a tile of 4 up to 4 vectors, else 8.
    A tile of 8 for 3 vectors would leave 5 of its columns empty.  Measured
    on an H100 (chip_smoke.py): at lkdvRK (3, 2)'s n = 9,600, B = 8, spread
    took 0.0172 ms and tile 0.0343; at swe M=512, B = 8, tile 0.0673 and
    spread 0.1062."""
    if _grid_blocks(n, dtype) < SMS or nvec == 1:
        return spmm_design("spread", n, nvec, dtype, strip)
    return spmm_design("tile", n, nvec, dtype, strip)


class LivePlan(NamedTuple):
    """The live diagonals of a DIA: ``words[c]`` has bit d set where
    ``data[d, c*chunk : (c+1)*chunk]`` holds a non-zero (int64, one word per
    chunk, on the data's device); ``chunk`` is a power of two; ``share`` is
    the share of the ndiag x n coefficients that lie in live segments."""

    words: torch.Tensor
    chunk: int
    share: float

    @property
    def pays(self) -> bool:
        """The plan skips at least ``LIVE_MIN_SKIP`` of the coefficients:
        a product launches the live design with it, else the dense one."""
        return self.share <= 1.0 - LIVE_MIN_SKIP


def warp_rows(dtype: torch.dtype) -> int:
    """Rows a warp of the kernel takes: 32 threads of 16 bytes each."""
    return 32 * 16 // (8 if dtype == torch.float64 else 4)


def live_chunk(dtype: torch.dtype) -> int:
    """The chunk of the live plan for data of ``dtype``: ``LIVE_CHUNK``, or
    a warp's rows where those are more."""
    return max(LIVE_CHUNK, warp_rows(dtype))


def live_plan(data: torch.Tensor, chunk: int) -> LivePlan:
    """The live plan of ``data`` (ndiag, n) for chunks of ``chunk`` rows, the
    last one ragged: one reduction of ``data != 0`` on the data's device,
    then one read of the live share on the host, which waits for the
    reduction (once per plan, never per launch).  Bit 63 is the sign bit of
    the int64 word; the bits are distinct, so their sum is their union."""
    if chunk < 1 or chunk & (chunk - 1):
        raise ValueError(f"chunk {chunk} is not a power of two")
    ndiag, n = data.shape
    if ndiag > MAX_DIAGS:
        raise ValueError(f"{ndiag} diagonals (at most {MAX_DIAGS})")
    nchunks = -(-n // chunk)
    nz = data != 0
    if nchunks * chunk != n:
        nz = torch.cat([nz, nz.new_zeros(ndiag, nchunks * chunk - n)], dim=1)
    live = nz.reshape(ndiag, nchunks, chunk).any(dim=2)
    bits = torch.ones((), dtype=torch.int64, device=data.device) << torch.arange(
        ndiag, dtype=torch.int64, device=data.device)
    words = (live.to(torch.int64) * bits[:, None]).sum(dim=0)
    rows = torch.full((nchunks,), chunk, dtype=torch.int64, device=data.device)
    if nchunks:
        rows[-1] = n - (nchunks - 1) * chunk
    share = float((live.to(torch.int64) * rows).sum()) / max(ndiag * n, 1)
    return LivePlan(words, chunk, share)


def shift(x: torch.Tensor, off: int, wrap: bool) -> torch.Tensor:
    """Row-aligned read of x at an offset: out[i] = x[i + off] (0 out of
    range unless wrapping).  Works along dim 0 of a vector or a matrix."""
    if off == 0:
        return x
    rolled = torch.roll(x, -off, dims=0)
    if wrap:
        return rolled
    n = x.shape[0]
    idx = torch.arange(n, device=x.device) + off
    valid = (idx >= 0) & (idx < n)
    if x.dim() > 1:
        valid = valid[:, None]
    return torch.where(valid, rolled, torch.zeros((), dtype=x.dtype, device=x.device))


def dia_spmv_torch(data: torch.Tensor, offsets: Sequence[int], wrap: bool,
                   x: torch.Tensor) -> torch.Tensor:
    """The plain version: one shifted copy of x per diagonal, summed in
    diagonal order (as ``ops/sparse.py::dia_spmv`` of the JAX package)."""
    dtype = torch.promote_types(data.dtype, x.dtype)
    y = torch.zeros(data.shape[1], dtype=dtype, device=x.device)
    for d, off in enumerate(offsets):
        y = y + data[d] * shift(x, int(off), wrap)
    return y


def dia_spmv_mixed_torch(data: torch.Tensor, offsets: Sequence[int],
                         wrap: bool, x: torch.Tensor) -> torch.Tensor:
    """The plain version of the mixed form: data and x upcast to f64, then
    the f64 product."""
    return dia_spmv_torch(data.double(), offsets, wrap, x.double())


def dia_spmm_torch(data: torch.Tensor, offsets: Sequence[int], wrap: bool,
                   X: torch.Tensor) -> torch.Tensor:
    """The plain version of the product with a block X (n, B): one shifted
    copy of X per diagonal, summed in diagonal order."""
    dtype = torch.promote_types(data.dtype, X.dtype)
    Y = torch.zeros((data.shape[1], X.shape[1]), dtype=dtype, device=X.device)
    for d, off in enumerate(offsets):
        Y = Y + data[d][:, None] * shift(X, int(off), wrap)
    return Y


def dia_spmv_window_torch(data: torch.Tensor, offsets: Sequence[int], lo: int,
                          x_ext: torch.Tensor) -> torch.Tensor:
    """The plain version of the windowed product: ``y[i] = sum_d data[d, i]
    * x_ext[lo + i + offsets[d]]``, summed in diagonal order (as the JAX
    package's ``parallel/halo_spmv.py`` sums its window)."""
    n = data.shape[1]
    y = torch.zeros(n, dtype=torch.promote_types(data.dtype, x_ext.dtype),
                    device=x_ext.device)
    for d, off in enumerate(offsets):
        y = y + data[d] * x_ext[lo + int(off): lo + int(off) + n]
    return y


def dia_spmv_window_mixed_torch(data: torch.Tensor, offsets: Sequence[int],
                                lo: int, x_ext: torch.Tensor) -> torch.Tensor:
    """The plain version of the windowed mixed product: f32 data and window
    upcast, then the f64 windowed product."""
    return dia_spmv_window_torch(data.double(), offsets, lo, x_ext.double())


def dia_spmm_window_torch(data: torch.Tensor, offsets: Sequence[int], lo: int,
                          X_ext: torch.Tensor) -> torch.Tensor:
    """The plain version of the windowed product with a block: X_ext (W, B)
    holds each vector's window as a column; (n, B)."""
    n = data.shape[1]
    Y = torch.zeros((n, X_ext.shape[1]),
                    dtype=torch.promote_types(data.dtype, X_ext.dtype),
                    device=X_ext.device)
    for d, off in enumerate(offsets):
        Y = Y + data[d][:, None] * X_ext[lo + int(off): lo + int(off) + n]
    return Y


def _check(data: torch.Tensor, offsets: Sequence[int], x: torch.Tensor) -> None:
    if data.device != x.device:
        raise ValueError(f"data on {data.device} but x on {x.device}")
    if x.dtype not in (torch.float64, torch.float32) or data.dtype != x.dtype:
        raise TypeError(
            f"DIA kernel takes f64 or f32 with data and x alike; got data "
            f"{data.dtype}, x {x.dtype}"
        )
    if data.dim() != 2 or x.dim() != 1 or data.shape[1] != x.shape[0]:
        raise ValueError(
            f"shapes: data {tuple(data.shape)} must be (ndiag, n) and x "
            f"{tuple(x.shape)} must be (n,)"
        )
    if data.shape[0] != len(offsets) or len(offsets) > MAX_DIAGS:
        raise ValueError(
            f"{len(offsets)} offsets for {data.shape[0]} diagonals "
            f"(at most {MAX_DIAGS})"
        )
    if not (data.is_contiguous() and x.is_contiguous()):
        raise ValueError("DIA kernel needs contiguous data and x")
    n = x.shape[0]
    if offsets and (max(offsets) >= n or min(offsets) <= -n):
        raise ValueError(f"offsets {tuple(offsets)} must lie in (-{n}, {n})")


def _check_plan(live: LivePlan, x: torch.Tensor) -> None:
    words, chunk = live.words, live.chunk
    n = x.shape[0]
    if (words.device != x.device or words.dtype != torch.int64
            or words.dim() != 1 or not words.is_contiguous()):
        raise ValueError(f"live plan of {words.dtype} {tuple(words.shape)} on "
                         f"{words.device}; x on {x.device}")
    if chunk & (chunk - 1) or chunk % warp_rows(x.dtype):
        raise ValueError(f"live chunk {chunk} is not a power of two holding "
                         f"whole warps of {warp_rows(x.dtype)} rows")
    if words.shape[0] != -(-n // chunk):
        raise ValueError(f"live plan of {words.shape[0]} chunks of {chunk} "
                         f"for n = {n}")


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype, mixed: bool = False):
    """The C entry point for ``dtype`` (the mixed form's for f32 data with
    ``mixed``), built and loaded on first use."""
    from .build import load

    lib = load("dia_spmv.cu")
    fn = (lib.dia_spmv_mixed if mixed
          else lib.dia_spmv_f64 if dtype == torch.float64
          else lib.dia_spmv_f32)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _entry_many(dtype: torch.dtype):
    """The C entry point of the batched kernel for ``dtype``, built and
    loaded on first use."""
    from .build import load

    lib = load("dia_spmm.cu")
    fn = lib.dia_spmm_f64 if dtype == torch.float64 else lib.dia_spmm_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@dataclasses.dataclass(frozen=True)
class DiaLaunch:
    """A DIA's launches of the kernel, resolved once: the design (live with
    a plan, dense without), the operator as the entry point takes it
    (``args``, which hold the addresses of ``data`` and the plan's words;
    ``keep`` keeps them alive) and the x it takes; ``many`` the operator's
    arguments of the batched kernel.  ``ops/sparse.py::DIA`` keeps its own,
    so a product costs the host the check of x and one C call."""

    design: str  # "live" or "dense"
    strip: int  # the batched kernel's strip (spmm_strip)
    n: int
    dtype: torch.dtype
    device: torch.device
    data_ptr: int
    args: tuple
    keep: tuple
    many: tuple
    # a windowed launch: x is a window of ``width`` columns, read from
    # ``base`` (window_launch); else x has the operator's n columns
    window: bool = False
    base: int = 0
    width: int = 0
    # the launch of an f32 DIA's kept f64 operator (``ops/sparse.py::
    # DIA.upcast``): ``launch`` counts it in ``UPCAST`` too
    upcast: bool = False

    def takes(self, x: torch.Tensor) -> bool:
        return x.dtype == self.dtype and x.device == self.device

    @property
    def cols(self) -> int:
        """The length of the x this launch reads."""
        return self.width if self.window else self.n

    def x_ptr(self, x: torch.Tensor) -> int:
        return x.data_ptr() + self.base * x.element_size()


def dia_launch(data: torch.Tensor, offsets: Sequence[int], wrap: bool,
               x: torch.Tensor, live: Optional[LivePlan] = None) -> DiaLaunch:
    """Check the operator (and the plan) against x, a CUDA vector, and
    resolve its launch: the live design with ``live``, the dense one
    without."""
    if x.device.type != "cuda":
        raise ValueError(f"the DIA kernel needs CUDA tensors, got {x.device}")
    _check(data, offsets, x)
    words, shift_, keep = None, 0, (data,)
    if live is not None:
        _check_plan(live, x)
        words, shift_ = live.words.data_ptr(), live.chunk.bit_length() - 1
        keep += (live.words,)
    offs = (ctypes.c_longlong * max(len(offsets), 1))(*map(int, offsets))
    args = (x.shape[0], len(offsets), offs, int(bool(wrap)), words, shift_,
            x.device.index or 0)
    many = (len(offsets), offs, int(bool(wrap)), words, shift_)
    return DiaLaunch("dense" if live is None else "live",
                     spmm_strip(x.shape[0], offsets, x.dtype), x.shape[0],
                     x.dtype, x.device, data.data_ptr(), args, keep, many)


def window_launch(data: torch.Tensor, offsets: Sequence[int], lo: int,
                  hi: int, x_ext: torch.Tensor,
                  live: Optional[LivePlan] = None) -> DiaLaunch:
    """Check a shard's rows of an operator, ``data`` (ndiag, n), against a
    CUDA window x_ext of ``lo + n + hi`` columns, and resolve its windowed
    launch: the live design with ``live`` (the shard's own plan), the dense
    one without.  Every offset lies in [-lo, hi]."""
    if x_ext.device.type != "cuda":
        raise ValueError(f"the DIA kernel needs CUDA tensors, got {x_ext.device}")
    ndiag, n = data.shape
    if offsets and (min(offsets) < -lo or max(offsets) > hi):
        raise ValueError(f"offsets {tuple(offsets)} reach outside the window "
                         f"[-{lo}, {hi}]")
    width = lo + n + hi
    if x_ext.dim() != 1 or x_ext.shape[0] != width:
        raise ValueError(f"a window of {width} columns, got {tuple(x_ext.shape)}")
    # the checks of an unwindowed launch on the shard's rows
    rec = dia_launch(data, [0] * ndiag, False, x_ext.new_empty(n), live)
    offs = (ctypes.c_longlong * max(ndiag, 1))(*map(int, offsets))
    args = (n, ndiag, offs, EDGE_WINDOW) + rec.args[4:]
    many = (ndiag, offs, EDGE_WINDOW) + rec.many[3:]
    return dataclasses.replace(
        rec, args=args, many=many, window=True, base=int(lo), width=width,
        strip=spmm_strip(n, offsets, x_ext.dtype))


def launch(rec: DiaLaunch, x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel as ``rec`` resolved it, on PyTorch's current
    stream; does not synchronise.  The launch counts in its design's counter
    and in ``dia_spmv_cuda``'s (a windowed one in ``dia_spmv_window_cuda``'s
    too, one on an upcast operator in ``UPCAST``)."""
    if (not rec.takes(x) or x.dim() != 1 or x.shape[0] != rec.cols
            or not x.is_contiguous()):
        raise ValueError(f"the launch takes a contiguous {rec.dtype} vector "
                         f"of {rec.cols} on {rec.device}; got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    y = x.new_empty(rec.n)
    if rec.n:
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _entry(rec.dtype)(rec.data_ptr, rec.x_ptr(x), y.data_ptr(),
                                *rec.args, stream)
        if err != 0:
            raise RuntimeError(
                f"dia_spmv kernel launch failed ({rec.design}): cudaError {err}")
    counter = (dia_spmv_live_cuda if rec.design == "live"
               else dia_spmv_dense_cuda)
    counter.launches += 1
    dia_spmv_cuda.launches += 1
    count_f32("dia_spmv", rec.dtype)
    if rec.window:
        dia_spmv_window_cuda.launches += 1
    if rec.upcast:
        UPCAST.launches += 1
    return y


def launch_mixed(rec: DiaLaunch, x: torch.Tensor) -> torch.Tensor:
    """Launch the mixed form as ``rec`` resolved it (an operator of f32 data,
    in its design) on the f32 vector x, on PyTorch's current stream; returns
    the f64 product.  Counts in ``dia_spmv_mixed_cuda`` (a windowed launch,
    ``window_launch``, in ``MIXED_WINDOW`` too); does not synchronise."""
    if (rec.dtype != torch.float32 or not rec.takes(x) or x.dim() != 1
            or x.shape[0] != rec.cols or not x.is_contiguous()):
        raise ValueError(f"the mixed launch takes f32 data and a contiguous "
                         f"f32 vector of {rec.cols} on {rec.device}; got "
                         f"data {rec.dtype}, x {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    y = torch.empty(rec.n, dtype=torch.float64, device=x.device)
    if rec.n:
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _entry(rec.dtype, True)(rec.data_ptr, rec.x_ptr(x),
                                      y.data_ptr(), *rec.args, stream)
        if err != 0:
            raise RuntimeError(f"dia_spmv_mixed kernel launch failed "
                               f"({rec.design}): cudaError {err}")
    dia_spmv_mixed_cuda.launches += 1
    if rec.window:
        MIXED_WINDOW.launches += 1
    return y


def launch_many(rec: DiaLaunch, X: torch.Tensor,
                plan: Optional[SpmmPlan] = None) -> torch.Tensor:
    """Launch the batched kernel as ``rec`` resolved it on the block X
    (n, B), on PyTorch's current stream; returns A X as an (n, B) view of a
    contiguous (B, n) tensor, so that a product of it is read without a
    copy.  X is read as B rows of length n at the stride ``X.stride(1)``
    where ``X.stride(0)`` is 1 (the view X.T of a (B, n) block); any other
    layout is copied into that one first.  ``plan``: the launch,
    ``spmm_plan``'s by default; a launch the kernel refuses raises.  The
    launch counts in ``dia_spmm_cuda``'s counter, its plan's and its
    design's (a windowed one, whose X holds each vector's window, in
    ``dia_spmm_window_cuda``'s too); does not synchronise."""
    if (not rec.takes(X) or X.dim() != 2 or X.shape[0] != rec.cols):
        raise ValueError(f"the batched launch takes a {rec.dtype} block of "
                         f"{rec.cols} rows on {rec.device}; got {X.dtype} "
                         f"{tuple(X.shape)} on {X.device}")
    nvec = X.shape[1]
    if X.stride(0) != 1 and rec.cols > 1:
        X = X.T.contiguous().T
    Y = torch.empty((nvec, rec.n), dtype=X.dtype, device=X.device)
    if nvec == 0:
        return Y.T
    if plan is None:
        plan = spmm_plan(rec.n, nvec, rec.dtype, rec.strip)
    if plan.design not in DESIGNS:
        raise ValueError(f"no batched design {plan.design!r}")
    stream = torch.cuda.current_stream(X.device).cuda_stream
    err = _entry_many(rec.dtype)(
        rec.data_ptr, rec.x_ptr(X), Y.data_ptr(), rec.n, nvec, X.stride(1),
        rec.n, *rec.many, int(plan.tile), int(plan.split), int(plan.strip),
        int(plan.depth), rec.args[-1], stream)
    if err != 0:
        raise RuntimeError(
            f"dia_spmm kernel launch failed ({rec.design}, {plan}): "
            f"cudaError {err}")
    counter = (dia_spmm_live_cuda if rec.design == "live"
               else dia_spmm_dense_cuda)
    counter.launches += 1
    _DESIGN_COUNTERS[plan.design].launches += 1
    dia_spmm_cuda.launches += 1
    count_f32("dia_spmm", rec.dtype)
    if rec.window:
        dia_spmm_window_cuda.launches += 1
    return Y.T


def dia_spmv_live_cuda(data: torch.Tensor, offsets: Sequence[int], wrap: bool,
                       live: LivePlan, x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel with a live plan on PyTorch's current stream; does
    not synchronise."""
    return launch(dia_launch(data, offsets, wrap, x, live), x)


def dia_spmv_dense_cuda(data: torch.Tensor, offsets: Sequence[int],
                        wrap: bool, x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel with every diagonal live on PyTorch's current
    stream; does not synchronise."""
    return launch(dia_launch(data, offsets, wrap, x), x)


def dia_spmv_cuda(data: torch.Tensor, offsets: Sequence[int], wrap: bool,
                  x: torch.Tensor,
                  live: Optional[LivePlan] = None) -> torch.Tensor:
    """Launch the kernel: the live design with a plan, the dense one
    without."""
    return launch(dia_launch(data, offsets, wrap, x, live), x)


def dia_spmv_mixed_cuda(data: torch.Tensor, offsets: Sequence[int],
                        wrap: bool, x: torch.Tensor,
                        live: Optional[LivePlan] = None) -> torch.Tensor:
    """Launch the mixed form (f32 data and x, f64 y): the live design with a
    plan, the dense one without; does not synchronise."""
    return launch_mixed(dia_launch(data, offsets, wrap, x, live), x)


def _column(X: torch.Tensor) -> torch.Tensor:
    """A vector like a column of X (n, B), on which a launch is resolved."""
    if X.dim() != 2:
        raise ValueError(f"a block of vectors is (n, B), got {tuple(X.shape)}")
    return X.new_empty(X.shape[0])


def dia_spmm_live_cuda(data: torch.Tensor, offsets: Sequence[int],
                       wrap: bool, live: LivePlan, X: torch.Tensor,
                       plan: Optional[SpmmPlan] = None) -> torch.Tensor:
    """Launch the batched kernel with a live plan on PyTorch's current
    stream; does not synchronise."""
    return launch_many(dia_launch(data, offsets, wrap, _column(X), live), X, plan)


def dia_spmm_dense_cuda(data: torch.Tensor, offsets: Sequence[int],
                        wrap: bool, X: torch.Tensor,
                        plan: Optional[SpmmPlan] = None) -> torch.Tensor:
    """Launch the batched kernel with every diagonal live on PyTorch's
    current stream; does not synchronise."""
    return launch_many(dia_launch(data, offsets, wrap, _column(X)), X, plan)


def dia_spmm_cuda(data: torch.Tensor, offsets: Sequence[int], wrap: bool,
                  X: torch.Tensor, live: Optional[LivePlan] = None,
                  plan: Optional[SpmmPlan] = None) -> torch.Tensor:
    """Launch the batched kernel: the live design with a plan, the dense
    one without, in ``plan``'s design (``spmm_plan``'s by default)."""
    return launch_many(dia_launch(data, offsets, wrap, _column(X), live), X, plan)


def _forced(design: str):
    def launch_design(data: torch.Tensor, offsets: Sequence[int], wrap: bool,
                      X: torch.Tensor,
                      live: Optional[LivePlan] = None) -> torch.Tensor:
        rec = dia_launch(data, offsets, wrap, _column(X), live)
        return launch_many(rec, X, spmm_design(design, rec.n, X.shape[1],
                                               X.dtype, rec.strip))

    launch_design.__name__ = launch_design.__qualname__ = f"dia_spmm_{design}_cuda"
    launch_design.__doc__ = (f"Launch the batched kernel in its {design} "
                             f"design (``spmm_design``), whatever the plan "
                             f"would pick; does not synchronise.")
    return launch_design


def dia_spmv_window_cuda(data: torch.Tensor, offsets: Sequence[int], lo: int,
                         hi: int, x_ext: torch.Tensor,
                         live: Optional[LivePlan] = None) -> torch.Tensor:
    """Launch the kernel on a window (``window_launch``) on PyTorch's
    current stream; does not synchronise."""
    return launch(window_launch(data, offsets, lo, hi, x_ext, live), x_ext)


def dia_spmm_window_cuda(data: torch.Tensor, offsets: Sequence[int], lo: int,
                         hi: int, X_ext: torch.Tensor,
                         live: Optional[LivePlan] = None,
                         plan: Optional[SpmmPlan] = None) -> torch.Tensor:
    """Launch the batched kernel on a block of windows X_ext (W, B) on
    PyTorch's current stream; does not synchronise."""
    rec = window_launch(data, offsets, lo, hi, _column(X_ext), live)
    return launch_many(rec, X_ext, plan)


dia_spmm_tile_cuda = _forced("tile")
dia_spmm_spread_cuda = _forced("spread")
_DESIGN_COUNTERS = {"tile": dia_spmm_tile_cuda, "spread": dia_spmm_spread_cuda}


# kernel launches of each design, and of either, for one vector and for a
# block; reset them to count a run
dia_spmv_live_cuda.launches = dia_spmv_dense_cuda.launches = 0
dia_spmv_cuda.launches = 0
dia_spmm_live_cuda.launches = dia_spmm_dense_cuda.launches = 0
dia_spmm_tile_cuda.launches = dia_spmm_spread_cuda.launches = 0
dia_spmm_cuda.launches = 0
dia_spmv_window_cuda.launches = dia_spmm_window_cuda.launches = 0
dia_spmv_mixed_cuda.launches = 0


def dia_spmv(data: torch.Tensor, offsets: Sequence[int], wrap: bool,
             x: torch.Tensor, live: Optional[LivePlan] = None) -> torch.Tensor:
    """The wrapper: CUDA tensors go through the kernel (with the live plan
    where one is given), CPU tensors through the plain version, which reads
    every diagonal."""
    if data.device != x.device:
        raise ValueError(f"data on {data.device} but x on {x.device}")
    if x.device.type == "cuda":
        return dia_spmv_cuda(data, offsets, wrap, x, live)
    if x.device.type == "cpu":
        return dia_spmv_torch(data, offsets, wrap, x)
    raise ValueError(f"no DIA SpMV for device {x.device}")



def dia_spmv_mixed(data: torch.Tensor, offsets: Sequence[int], wrap: bool,
                   x: torch.Tensor,
                   live: Optional[LivePlan] = None) -> torch.Tensor:
    """The mixed form's wrapper, f32 data and x to an f64 y: CUDA tensors go
    through the kernel, CPU tensors through the plain version."""
    if data.device != x.device:
        raise ValueError(f"data on {data.device} but x on {x.device}")
    if x.device.type == "cuda":
        return dia_spmv_mixed_cuda(data, offsets, wrap, x, live)
    if x.device.type == "cpu":
        return dia_spmv_mixed_torch(data, offsets, wrap, x)
    raise ValueError(f"no DIA SpMV for device {x.device}")

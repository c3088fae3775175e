// DIA sparse matrix product with a block of vectors for Hopper (sm_90a), f64
// and f32: B vectors that share one operator.
//
//   Y[b, i] = sum_d data[d, i] * X[b, i + off_d],   b = 0 .. B-1
//
// with the column wrapped mod n or a structural zero outside [0, n), as in
// csrc/dia_spmv.cu (kernel #1, whose live plan and row layout this kernel
// shares).  X is read as B rows of length n at a row stride `ldx`, so the
// (n, B) view X.T of a contiguous (B, n) block (a block of Krylov basis
// rows) is read without a copy; Y is written as B rows at a stride `ldy`.
//
// Replaces the JAX package's ops/pallas_spmv.py::dia_spmv_pallas under
// jax.vmap: experiments/batched.py::cgmres_many vmaps the CGMRES core with
// A closed over, and pallas_call's batching rule runs the kernel once more
// for every vector, each time reading the operator again.
//
// What bounds it: bytes, at the bound.  The operator's stored non-zeros are
// read once for the block and the B vectors are read and written once
// each: at swe M=512 (6.33 non-zeros a row, n = 786,432) with B = 8 that
// is 39.8 MB of coefficients and 100.7 MB of vectors, 0.0419 ms at 3.35
// TB/s.  The multiply-adds (2 x 6.33 x B a row) are far below the f64
// rate.  In practice three things stand between a kernel and that bound:
// x is read once per diagonal, and only the L1 and L2 caches make those
// reads cheap; a warp's chain of dependent loads (the plan's word, then
// its diagonals); and, once the loads are in flight, the integer
// instructions that compute their addresses.  At small n (lkdvRK's stage
// operator, n = 9,600) the bound is under a microsecond and the chain is
// the whole time.
//
// Two designs, picked by kernels/dia_spmv.py::spmm_plan from the shapes
// (chip_smoke.py times both at every path shape):
//
// * tile (large n).  A warp takes 32 x RPT rows in one chunk of the live
//   plan, reads the chunk's word and walks its set bits in ascending d,
//   one diagonal at a time: a tile of TB vectors' x values (4 or 8) and
//   the RPT coefficients are loaded into registers before their
//   multiply-adds.  Where the warp's columns lie in [0, n) (all but a few
//   warps), the loads of a vector share one address, with no wrap or range
//   test per element; the rest read through x_at.  A block of more than TB
//   vectors loops over its tiles against the same rows: the coefficients
//   are loaded evict-first on the last tile only, so the earlier tiles
//   leave them in L1 and L2 and device memory serves them once.  The
//   blocks are taken in strips (block_span): an operator whose far offsets
//   couple rows a strip apart (swe's three fields of M^2 rows) finds in L2
//   the x that the other strips' blocks have just read, where in row order
//   it read x three times from memory.
// * spread (small n, and one vector).  The same loop, four diagonals'
//   loads in flight (as kernel #1), with the vectors split over a grid
//   axis, `group` vectors a block column (down to one), so that a card
//   that one vector's rows would leave mostly idle is covered: each warp
//   then walks its diagonals for one vector.
//
// Why not shared memory: a design that brought each diagonal's
// coefficients and x window into a ring of slots by bulk copies
// (cp.async.bulk) lost to the tile design at every shape (PERF.md §6),
// since each stage copied x from L2 again where the register loads find it
// in L1.
//
// The kernel allocates nothing and uses no shared memory, so it is captured
// in CUDA graphs as it is.
// Semantics: each (row, vector) sums its live diagonals in ascending d with
// fused multiply-adds, as kernel #1 does, in both designs, so column b of
// the product is kernel #1's product of vector b bit for bit.  A null plan
// reads every diagonal (the dense design).  Index arithmetic is 64-bit.

#include "dia_row.cuh"

// ---------------------------------------------------------------------------
// the rows of a block

// Block column `bid` takes rows [r0, end): the rows are cut into strips of
// `strip` rows (n itself for one strip), and consecutive blocks take a block
// of R rows from each strip in turn, so that blocks that run together read x
// near the same rows of every strip.  An operator whose far offsets couple
// rows a strip apart (swe's three fields, M^2 rows each) then finds the x
// that its other strips' blocks have just read in L2.
__device__ __forceinline__ void block_span(long long bid, long long R,
                                           long long strip, long long n,
                                           long long& r0, long long& end) {
  const long long strips = (n + strip - 1) / strip;
  const long long f = bid % strips, p = bid / strips;
  r0 = f * strip + p * R;
  end = r0 + R;
  if (end > (f + 1) * strip) end = (f + 1) * strip;
  if (end > n) end = n;
}

// ---------------------------------------------------------------------------
// the kernel

// VEC: thread t of a warp holds rows w0 + RPT t + k (n % RPT == 0, so all
// or none of them exist); otherwise rows w0 + t + 32 k.  Block column
// blockIdx.y takes vectors [blockIdx.y * group, + group).
template <typename T, bool WRAP, bool VEC, int TB, int DB>
__global__ void __launch_bounds__(DIA_THREADS)
    dia_spmm_kernel(const T* __restrict__ data, const T* __restrict__ x,
                  T* __restrict__ y, long long n, long long nvec,
                  long long ldx, long long ldy, int ndiag,
                  const unsigned long long* __restrict__ live,
                  int chunk_shift, long long group, long long strip,
                  const __grid_constant__ DiaOffsets offs) {
  constexpr int RPT = 16 / sizeof(T);
  constexpr int WARP_ROWS = 32 * RPT;
  const int lane = threadIdx.x & 31;
  long long r0, end;
  block_span(blockIdx.x, (long long)DIA_THREADS * RPT, strip, n, r0, end);
  const long long w0 = r0 + (long long)(threadIdx.x >> 5) * WARP_ROWS;
  if (w0 >= end) return;
  long long row[RPT];
  bool in[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    row[k] = VEC ? w0 + RPT * lane + k : w0 + lane + 32 * k;
    in[k] = row[k] < end;
  }
  const unsigned long long all =
      ndiag >= 64 ? ~0ULL : ((1ULL << ndiag) - 1ULL);
  const unsigned long long word =
      live ? (__ldg(live + (w0 >> chunk_shift)) & all) : all;
  const bool full = w0 + WARP_ROWS <= end;  // every row of the warp exists
  const long long g0 = (long long)blockIdx.y * group;
  const long long g1 = nvec < g0 + group ? nvec : g0 + group;
  for (long long b0 = g0; b0 < g1; b0 += TB) {
    const int nb = (int)(g1 - b0 < TB ? g1 - b0 : TB);
    // the block column's last tile: its coefficient loads are the last
    const bool last = b0 + TB >= g1;
    const T* xt = x + b0 * ldx;
    T acc[TB][RPT];
#pragma unroll
    for (int t = 0; t < TB; ++t)
#pragma unroll
      for (int k = 0; k < RPT; ++k) acc[t][k] = T(0);
    unsigned long long m = word;
    while (m) {
      // the batch's first diagonal exists (m is not empty); the others may
      // not (-1), and are skipped
      int dd[DB];
      dd[0] = __ffsll((long long)m) - 1;
      m &= m - 1ULL;
#pragma unroll
      for (int u = 1; u < DB; ++u) {
        dd[u] = m ? __ffsll((long long)m) - 1 : -1;
        m &= m - 1ULL;  // stays 0 once empty
      }
      T a[DB][RPT], xv[DB][TB][RPT];
#pragma unroll
      for (int u = 0; u < DB; ++u) {
        if (u > 0 && dd[u] < 0) continue;
        const T* drow = data + (long long)dd[u] * n;
        const long long off = offs.off[dd[u]];
        if (VEC) {
          using V = typename Vec16<T>::type;
          if (in[0]) {
            const V* p = reinterpret_cast<const V*>(drow + row[0]);
            Vec16<T>::split(last ? __ldcs(p) : __ldg(p), a[u]);
          }
        } else {
#pragma unroll
          for (int k = 0; k < RPT; ++k)
            a[u][k] = in[k] ? (last ? __ldcs(drow + row[k]) : __ldg(drow + row[k]))
                            : T(0);
        }
        if (full && w0 + off >= 0 && w0 + off + WARP_ROWS <= n) {
          // the warp's columns lie in [0, n): no wrap, no fill, and the
          // loads of a vector share one address (the k-th at a constant
          // offset from it)
          const T* xp = xt + row[0] + off;
#pragma unroll
          for (int t = 0; t < TB; ++t) {
#pragma unroll
            for (int k = 0; k < RPT; ++k)
              xv[u][t][k] = t < nb ? __ldg(xp + (VEC ? k : 32 * k)) : T(0);
            xp += ldx;
          }
        } else {
#pragma unroll
          for (int t = 0; t < TB; ++t)
#pragma unroll
            for (int k = 0; k < RPT; ++k)
              xv[u][t][k] = (t < nb && in[k])
                                ? x_at<T, WRAP>(xt + t * ldx, row[k] + off, n)
                                : T(0);
        }
      }
#pragma unroll
      for (int u = 0; u < DB; ++u) {
        if (u > 0 && dd[u] < 0) continue;
#pragma unroll
        for (int t = 0; t < TB; ++t)
#pragma unroll
          for (int k = 0; k < RPT; ++k) acc[t][k] += a[u][k] * xv[u][t][k];
      }
    }
    T* yt = y + b0 * ldy;
#pragma unroll
    for (int t = 0; t < TB; ++t) {
      if (t >= nb) break;
      if (VEC) {
        if (in[0])
          *reinterpret_cast<typename Vec16<T>::type*>(yt + t * ldy + row[0]) =
              Vec16<T>::join(acc[t]);
      } else {
#pragma unroll
        for (int k = 0; k < RPT; ++k)
          if (in[k]) yt[t * ldy + row[k]] = acc[t][k];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch

struct SpmmArgs {
  const void* data;
  const void* x;
  void* y;
  long long n, nvec, ldx, ldy;
  int ndiag;
  const unsigned long long* live;
  int chunk_shift;
  long long group, strip;
  cudaStream_t s;
};

template <typename T, bool WRAP, bool VEC, int TB, int DB>
static void run(const SpmmArgs& a, const DiaOffsets& offs, dim3 grid) {
  dia_spmm_kernel<T, WRAP, VEC, TB, DB><<<grid, DIA_THREADS, 0, a.s>>>(
      (const T*)a.data, (const T*)a.x, (T*)a.y, a.n, a.nvec, a.ldx, a.ldy,
      a.ndiag, a.live, a.chunk_shift, a.group, a.strip, offs);
}

template <typename T, int TB, int DB>
static void dispatch(bool wrap, bool vec, const SpmmArgs& a,
                     const DiaOffsets& offs, dim3 grid) {
  if (wrap) {
    if (vec) run<T, true, true, TB, DB>(a, offs, grid);
    else run<T, true, false, TB, DB>(a, offs, grid);
  } else {
    if (vec) run<T, false, true, TB, DB>(a, offs, grid);
    else run<T, false, false, TB, DB>(a, offs, grid);
  }
}

// the (tile, depth) pairs built: the tile design's (4 or 8 vectors, one
// diagonal in flight) and the spread design's (1 or 2 vectors, four);
// anything else is refused
template <typename T>
static bool dispatch_tile(int tile, int depth, bool wrap, bool vec,
                          const SpmmArgs& a, const DiaOffsets& offs,
                          dim3 grid) {
  switch (tile * 16 + depth) {
    case 8 * 16 + 1: dispatch<T, 8, 1>(wrap, vec, a, offs, grid); return true;
    case 4 * 16 + 1: dispatch<T, 4, 1>(wrap, vec, a, offs, grid); return true;
    case 1 * 16 + 4: dispatch<T, 1, 4>(wrap, vec, a, offs, grid); return true;
    case 2 * 16 + 4: dispatch<T, 2, 4>(wrap, vec, a, offs, grid); return true;
    default: return false;
  }
}

// live: one word per chunk of 2^chunk_shift rows, or null for every
// diagonal; a chunk holds whole warps (checked here).  tile: the vectors a
// thread sums at a time; depth: the diagonals in flight; group: the vectors
// of a block column (the grid's y axis splits the block into nvec / group
// columns); strip: the rows of a strip (block_span), n or a multiple of a
// warp's rows
template <typename T>
static int launch(const void* data, const void* x, void* y, long long n,
                  long long nvec, long long ldx, long long ldy, int ndiag,
                  const long long* offsets, int wrap, const void* live,
                  int chunk_shift, int tile, long long group, long long strip,
                  int depth, int device, void* stream) {
  constexpr int RPT = 16 / sizeof(T);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ndiag < 0 || ndiag > DIA_MAX_DIAGS || n < 1 || nvec < 1 ||
      (nvec > 1 && (ldx < n || ldy < n)) || group < 1 ||
      (nvec + group - 1) / group > 65535 || strip < 1 ||
      (strip < n && strip % (32 * RPT) != 0))
    return (int)cudaErrorInvalidValue;
  if (live && (chunk_shift < 0 || chunk_shift > 40 ||
               (1LL << chunk_shift) % (32 * RPT) != 0))
    return (int)cudaErrorInvalidValue;
  if (strip > n) strip = n;
  DiaOffsets offs;
  for (int d = 0; d < DIA_MAX_DIAGS; ++d) offs.off[d] = d < ndiag ? offsets[d] : 0;
  SpmmArgs a{data, x, y, n, nvec, ldx, ldy, ndiag,
             (const unsigned long long*)live, chunk_shift, group, strip,
             (cudaStream_t)stream};
  const long long block_rows = (long long)DIA_THREADS * RPT;
  const long long blocks =
      (n + strip - 1) / strip * ((strip + block_rows - 1) / block_rows);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec = n % RPT == 0 && (nvec == 1 || ldy % RPT == 0) &&
                   (uintptr_t)data % 16 == 0 && (uintptr_t)y % 16 == 0;
  const dim3 grid((unsigned)blocks, (unsigned)((nvec + group - 1) / group));
  if (!dispatch_tile<T>(tile, depth, wrap, vec, a, offs, grid))
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" {

int dia_spmm_f64(const void* data, const void* x, void* y, long long n,
                 long long nvec, long long ldx, long long ldy, int ndiag,
                 const long long* offsets, int wrap, const void* live,
                 int chunk_shift, int tile, long long group, long long strip,
                 int depth, int device, void* stream) {
  return launch<double>(data, x, y, n, nvec, ldx, ldy, ndiag, offsets, wrap,
                        live, chunk_shift, tile, group, strip, depth, device,
                        stream);
}

int dia_spmm_f32(const void* data, const void* x, void* y, long long n,
                 long long nvec, long long ldx, long long ldy, int ndiag,
                 const long long* offsets, int wrap, const void* live,
                 int chunk_shift, int tile, long long group, long long strip,
                 int depth, int device, void* stream) {
  return launch<float>(data, x, y, n, nvec, ldx, ldy, ndiag, offsets, wrap,
                       live, chunk_shift, tile, group, strip, depth, device,
                       stream);
}

}  // extern "C"

// Constant-stencil SpMV with its boundary-strip correction, for Hopper
// (sm_90a), f64 and f32, in two designs.
//
//   y[i] = sum_d c_d * x[i + off_d]  +  E[i, :] x
//
// The row arithmetic, and the layout of the strips (the residuals of a
// structured-grid operator against its constants on the boundary rows and
// columns of the (R, C) grid view, C = grid_c), are in stencil_row.cuh,
// which the fused polynomial applies of poly_apply.cu and poly_tiled.cu
// share.  grid_c == 0 means no strips (an exactly constant operator,
// possibly periodic); strips never come with wrap.
//
// Replaces the TPU kernel ops/pallas_spmv.py::stencil_spmv_pallas of the JAX
// package, together with the separate strip pass ops/stencil.py::
// _apply_strips that follows it there.  The Pallas kernel rotates a
// (rows, 128)-lane view of x with a halo per program; that layout serves the
// TPU's vector unit and is not carried over.
//
// What bounds it: bytes, in principle.  No coefficient row is read: the work
// per row is ndiag multiply-adds against ndiag reads of x, which after the
// first touch come from L1 or L2 (x is 8.4 MB in f64 at heat M=1024, n =
// 1,050,625, against a 50 MB L2).  Device-memory traffic is x once and y
// once, 2 * n * sizeof(T), plus the strips, 2 * (C + R) * ndiag *
// sizeof(T) -- about 17 MB per f64 product at heat M=1024, 0.4 flop per
// byte.  In practice the flat design below is bound by the instructions it
// issues per row, not by those bytes.
//
// The flat design (stencil_spmv_kernel): one thread per flat row in a
// grid-stride loop, so a warp reads 32 consecutive entries of x at each
// shift and writes 32 consecutive results.  Per row it pays a 64-bit
// division (the strip test), ndiag 64-bit shifted indices with their range
// tests and the four strip tests.  It serves every stencil: without strips,
// periodic, or with offsets beyond one grid row and column.
//
// The tiled design (stencil_tiled_kernel), for a stencil with strips whose
// ascending offsets all lie in the 3 x 3 box of one grid row and one grid
// column (heat's seven points), on a grid of at least 3 x 3; the host picks
// it from the shapes (kernels/stencil_spmv.py::stencil_plan).
//   - The interior points (grid rows 1 .. R-2, columns 1 .. C-2) are cut
//     into 2-D tiles of TX columns by TY * RUN rows; a block of TX x TY
//     threads takes a tile, and r and col come from blockIdx and threadIdx
//     with no division.  The block first copies the tile and a one-point
//     halo into shared memory, every copy in flight at once (cp.async, a
//     warp a row of the tile, its lanes on consecutive addresses), so each
//     x is read once per tile and the tile waits on one round trip to
//     device memory.  A thread then walks down a run of RUN rows of one
//     column and keeps the 3 x 3 window in registers: three shared loads a
//     point, no range test, no strip test.  A buffer point is the flat
//     index (r0 - 1 + i) C + (c0 - 1 + j) whatever its column, so every
//     shifted read of an interior point is x[f + dr C + dc] = x[f + off_d]:
//     the flat read, in [0, n).
//   - The product sums the present cells of the box in row-major order,
//     which is the ascending order of the offsets; a cell no offset lands
//     in is skipped (a uniform test of a launch constant).  So each point
//     takes the flat design's multiply-adds in the flat design's order, and
//     the two designs give the same bits.
//   - The 4C - 4 strip points (grid rows 0 and R-1, columns 0 and C-1) are
//     taken apart, one a thread, in the first rows of blocks, and take
//     stencil_sum with the flat shifted reads, as the flat design does,
//     given r and col.  A strip thread first prefetches into L1 every x and
//     strip coefficient that stencil_sum will read: its loops run to a
//     launch constant and would otherwise wait on one load after another.
// Index arithmetic on the grid is 64-bit; the strips are read only by the
// strip points.
//
// The block form (#2b): the same launch over nvec vectors, the rows of a
// (B, n) block read through its (n, B) view, x's rows ldx apart and y's ldy
// apart, one more grid axis over the vectors (y in the flat design, z in
// the tiled one).  It replaces the JAX package's stencil_spmv_pallas under
// jax.vmap, which pallas_call's batching rule gives a grid axis over the
// batch.  Each block serves one vector with the code of one product, so
// each column takes kernel #2's bits on that vector.  A row may start at
// any element offset (at heat M=1024, n = 1,050,625 is odd, so every row
// after the first starts at an odd one): every load, copy and store is of
// one T, none assumes more alignment than that.  Its bound is the vectors'
// bytes, B times one product's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stencil_row.cuh"

#define STENCIL_TILE_MAX_THREADS 256
// a block's shared memory without the opt-in attribute
#define STENCIL_TILE_MAX_SMEM 49152
// vectors of one launch: the grid's y axis (flat) or z axis (tiled)
#define STENCIL_MAX_VECTORS 65535

template <typename T, bool WRAP>
__global__ void stencil_spmv_kernel(const T* __restrict__ x,
                                    T* __restrict__ y, long long ldx,
                                    long long ldy, long long n,
                                    int ndiag, StencilParams<T> p,
                                    long long C, long long R,
                                    const T* __restrict__ top,
                                    const T* __restrict__ bot,
                                    const T* __restrict__ left,
                                    const T* __restrict__ right) {
  // the vector of this block: row blockIdx.y of the block of vectors
  x += (long long)blockIdx.y * ldx;
  y += (long long)blockIdx.y * ldy;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const ReadOnlyLoad<T> ld{x};
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    y[i] = stencil_row<T, WRAP>(ld, i, n, ndiag, p, C, R, top, bot, left,
                                right);
  }
}

// The stencil on its grid, for the tiled design
template <typename T>
struct TiledStencil {
  StencilParams<T> p;  // the offsets' chain, for the strip points
  T box[9];   // the constants on the 3 x 3 box, (dr, dc) = (-1, -1) ... (1, 1)
  int cells;  // bit k set where an offset lands in box cell k
  int ndiag;
  int strip_rows;  // rows of strip blocks in the grid of blocks; tiles after
  long long n, C, R;
  long long nstrip;  // 2 C + 2 (R - 2)
  const T* top;
  const T* bot;
  const T* left;
  const T* right;
};

// the present cells of rows u (above), m and d (below) of the window, in
// row-major order
template <typename T>
__device__ __forceinline__ T box_chain(const TiledStencil<T>& op,
                                       const T (&u)[3], const T (&m)[3],
                                       const T (&d)[3]) {
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < 3; ++k)
    if (op.cells & (1 << k)) acc += op.box[k] * u[k];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    if (op.cells & (8 << k)) acc += op.box[3 + k] * m[k];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    if (op.cells & (64 << k)) acc += op.box[6 + k] * d[k];
  return acc;
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

// an asynchronous copy of one T from device to shared memory, or a zero
// where `ok` is false (nothing is read then)
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(sizeof(T)), "r"(ok ? (int)sizeof(T) : 0));
}

template <typename T, int RUN>
__global__ void __launch_bounds__(STENCIL_TILE_MAX_THREADS)
    stencil_tiled_kernel(const __grid_constant__ TiledStencil<T> op,
                         const T* __restrict__ x, T* __restrict__ y,
                         long long ldx, long long ldy) {
  // the vector of this block: row blockIdx.z of the block of vectors
  x += (long long)blockIdx.z * ldx;
  y += (long long)blockIdx.z * ldy;
  const long long C = op.C;
  if ((int)blockIdx.y >= op.strip_rows) {
    // an interior tile of TX columns by TY * RUN rows from (r0, c0), and
    // its buffer: the tile and a one-point halo, buffer point (i, j) at
    // flat index (r0 - 1 + i) C + (c0 - 1 + j), zero from n on (the last
    // tile's columns past C - 2 are not computed)
    extern __shared__ __align__(16) unsigned char smem[];
    T* buf = reinterpret_cast<T*>(smem);
    const int TX = blockDim.x, TY = blockDim.y;
    const int rows = TY * RUN + 2, cols = TX + 2;
    const long long c0 = 1 + (long long)blockIdx.x * TX;
    const long long r0 = 1 + (long long)(blockIdx.y - op.strip_rows) * TY * RUN;
    const long long first = (r0 - 1) * C + (c0 - 1);
    const T* base = x + first;
    // every copy of the tile in flight at once: a warp a row, its lanes on
    // consecutive columns
    for (int i = threadIdx.y; i < rows; i += TY) {
      const long long row = (long long)i * C;
      for (int j = threadIdx.x; j < cols; j += TX) {
        const bool ok = first + row + j < op.n;
        copy_async(buf + i * cols + j, ok ? base + row + j : x, ok);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    // this thread's column and run of rows, and its window in the buffer
    const long long col = c0 + threadIdx.x;
    const long long r = r0 + (long long)threadIdx.y * RUN;
    if (col > C - 2 || r > op.R - 2) return;
    const T* b = buf + threadIdx.y * RUN * cols + threadIdx.x;
    T* q = y + r * C + col;
    // the run, cut at the grid's last interior row
    const long long run = min((long long)RUN, op.R - 1 - r);
    T u[3], m[3], d[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      u[c] = b[c];
      m[c] = b[cols + c];
    }
#pragma unroll
    for (int k = 0; k < RUN; ++k) {
      if (k == run) break;
#pragma unroll
      for (int c = 0; c < 3; ++c) d[c] = b[(k + 2) * cols + c];
      q[k * C] = box_chain(op, u, m, d);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        u[c] = m[c];
        m[c] = d[c];
      }
    }
    return;
  }
  // the strip points, one a thread: grid rows 0 and R - 1, then grid
  // columns 0 and C - 1 of rows 1 .. R - 2
  const long long q =
      ((long long)blockIdx.y * gridDim.x + blockIdx.x) *
          (blockDim.x * blockDim.y) +
      threadIdx.y * blockDim.x + threadIdx.x;
  if (q >= op.nstrip) return;
  long long r, col;
  if (q < C) {
    r = 0;
    col = q;
  } else if (q < 2 * C) {
    r = op.R - 1;
    col = q - C;
  } else if (q < 2 * C + op.R - 2) {
    r = 1 + (q - 2 * C);
    col = 0;
  } else {
    r = 1 + (q - 2 * C - (op.R - 2));
    col = C - 1;
  }
  const long long f = r * C + col;
  for (int d = 0; d < op.ndiag; ++d) {
    const long long j = f + op.p.off[d];
    if (j >= 0 && j < op.n) prefetch_l1(x + j);
    if (r == 0) prefetch_l1(op.top + (long long)d * C + col);
    if (r == op.R - 1) prefetch_l1(op.bot + (long long)d * C + col);
    if (col == 0) prefetch_l1(op.left + (long long)d * op.R + r);
    if (col == C - 1) prefetch_l1(op.right + (long long)d * op.R + r);
  }
  const ReadOnlyLoad<T> ld{x};
  const auto xv = [&](int d) {
    return shifted<T, false>(ld, f + op.p.off[d], op.n);
  };
  y[f] = stencil_sum<T>(xv, f, r, col, op.n, op.ndiag, op.p, C, op.R, op.top,
                        op.bot, op.left, op.right);
}

template <typename T>
static void fill_params(StencilParams<T>* p, int ndiag,
                        const long long* offsets, const double* consts) {
  for (int d = 0; d < STENCIL_MAX_DIAGS; ++d) {
    p->off[d] = d < ndiag ? offsets[d] : 0;
    p->c[d] = d < ndiag ? (T)consts[d] : T(0);
  }
}

// The vectors: nvec rows of n values, x's ldx apart and y's ldy apart (at
// least n, so that no two rows overlap; any element offset, odd ones too:
// every load and store is of one T).
static bool rows_ok(long long n, int nvec, long long ldx, long long ldy) {
  return nvec >= 1 && nvec <= STENCIL_MAX_VECTORS &&
         (nvec == 1 || (ldx >= n && ldy >= n));
}

template <typename T>
static int launch(const void* x, void* y, int nvec, long long ldx,
                  long long ldy, long long n, int ndiag,
                  const long long* offsets, const double* consts, int wrap,
                  long long grid_c, const void* top, const void* bot,
                  const void* left, const void* right, int device,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ndiag < 0 || ndiag > STENCIL_MAX_DIAGS || !rows_ok(n, nvec, ldx, ldy))
    return (int)cudaErrorInvalidValue;
  if (grid_c < 0 || (grid_c > 0 && (wrap || n % grid_c != 0)))
    return (int)cudaErrorInvalidValue;
  StencilParams<T> p;
  fill_params(&p, ndiag, offsets, consts);
  const long long R = grid_c > 0 ? n / grid_c : 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 8192) blocks = 8192;  // grid-stride loop covers the rest
  if (blocks < 1) blocks = 1;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)blocks, (unsigned)nvec);
  if (wrap) {
    stencil_spmv_kernel<T, true><<<grid, threads, 0, s>>>(
        (const T*)x, (T*)y, ldx, ldy, n, ndiag, p, 0, 0, nullptr, nullptr,
        nullptr, nullptr);
  } else {
    stencil_spmv_kernel<T, false><<<grid, threads, 0, s>>>(
        (const T*)x, (T*)y, ldx, ldy, n, ndiag, p, grid_c, R, (const T*)top,
        (const T*)bot, (const T*)left, (const T*)right);
  }
  return (int)cudaGetLastError();
}

// The tiled design, checked: a grid of R >= 3 rows of C >= 3 columns,
// strips, offsets in ascending order, each in the 3 x 3 box (box_cell).
// plan: tx (a multiple of 32), ty, run (4, 8 or 16), tx * ty <= 256, and
// the buffer (ty run + 2) (tx + 2) within the default 48 KB of shared memory.
template <typename T>
static int launch_tiled(const void* x, void* y, int nvec, long long ldx,
                        long long ldy, long long n, int ndiag,
                        const long long* offsets, const double* consts,
                        long long grid_c, const void* top, const void* bot,
                        const void* left, const void* right, const int* plan,
                        int device, void* stream) {
  const int tx = plan[0], ty = plan[1], run = plan[2];
  if (!rows_ok(n, nvec, ldx, ldy) || ndiag < 1 || ndiag > 9 || grid_c < 3 ||
      n < 1 || n % grid_c != 0 ||
      n / grid_c < 3 || !top || !bot || !left || !right || tx < 32 ||
      tx % 32 != 0 || ty < 1 || tx * ty > STENCIL_TILE_MAX_THREADS ||
      (run != 4 && run != 8 && run != 16))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  TiledStencil<T> op;
  fill_params(&op.p, ndiag, offsets, consts);
  for (int k = 0; k < 9; ++k) op.box[k] = T(0);
  op.cells = 0;
  for (int d = 0; d < ndiag; ++d) {
    int dr, dc;
    if (!box_cell(offsets[d], grid_c, &dr, &dc) ||
        (d > 0 && offsets[d] <= offsets[d - 1]))
      return (int)cudaErrorInvalidValue;  // the box sums in this order
    const int k = (dr + 1) * 3 + (dc + 1);
    op.box[k] = (T)consts[d];
    op.cells |= 1 << k;
  }
  op.ndiag = ndiag;
  op.n = n;
  op.C = grid_c;
  op.R = n / grid_c;
  op.nstrip = 2 * op.C + 2 * (op.R - 2);
  op.top = (const T*)top;
  op.bot = (const T*)bot;
  op.left = (const T*)left;
  op.right = (const T*)right;
  const long long tiles_c = (op.C - 2 + tx - 1) / tx;
  const long long tiles_r = (op.R - 2 + (long long)ty * run - 1) / ((long long)ty * run);
  const long long strip_blocks = (op.nstrip + tx * ty - 1) / (tx * ty);
  const long long strip_rows = (strip_blocks + tiles_c - 1) / tiles_c;
  if (tiles_c > 0x7fffffffLL || tiles_r + strip_rows > 65535)
    return (int)cudaErrorInvalidValue;
  op.strip_rows = (int)strip_rows;
  const dim3 grid((unsigned)tiles_c, (unsigned)(tiles_r + strip_rows),
                  (unsigned)nvec);
  const dim3 block((unsigned)tx, (unsigned)ty);
  const size_t smem = (size_t)(ty * run + 2) * (tx + 2) * sizeof(T);
  if (smem > STENCIL_TILE_MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const T* xp = (const T*)x;
  T* yp = (T*)y;
  if (run == 4)
    stencil_tiled_kernel<T, 4><<<grid, block, smem, s>>>(op, xp, yp, ldx, ldy);
  else if (run == 8)
    stencil_tiled_kernel<T, 8><<<grid, block, smem, s>>>(op, xp, yp, ldx, ldy);
  else
    stencil_tiled_kernel<T, 16><<<grid, block, smem, s>>>(op, xp, yp, ldx,
                                                          ldy);
  return (int)cudaGetLastError();
}

extern "C" {

// x, y: nvec rows of n values, ldx and ldy apart (the vector of one
// product: nvec = 1)
int stencil_spmv_f64(const void* x, void* y, int nvec, long long ldx,
                     long long ldy, long long n, int ndiag,
                     const long long* offsets, const double* consts, int wrap,
                     long long grid_c, const void* top, const void* bot,
                     const void* left, const void* right, int device,
                     void* stream) {
  return launch<double>(x, y, nvec, ldx, ldy, n, ndiag, offsets, consts,
                        wrap, grid_c, top, bot, left, right, device, stream);
}

int stencil_spmv_f32(const void* x, void* y, int nvec, long long ldx,
                     long long ldy, long long n, int ndiag,
                     const long long* offsets, const double* consts, int wrap,
                     long long grid_c, const void* top, const void* bot,
                     const void* left, const void* right, int device,
                     void* stream) {
  return launch<float>(x, y, nvec, ldx, ldy, n, ndiag, offsets, consts,
                       wrap, grid_c, top, bot, left, right, device, stream);
}

// plan: tx, ty, run (launch_tiled)
int stencil_tiled_f64(const void* x, void* y, int nvec, long long ldx,
                      long long ldy, long long n, int ndiag,
                      const long long* offsets, const double* consts,
                      long long grid_c, const void* top, const void* bot,
                      const void* left, const void* right, const int* plan,
                      int device, void* stream) {
  return launch_tiled<double>(x, y, nvec, ldx, ldy, n, ndiag, offsets,
                              consts, grid_c, top, bot, left, right, plan,
                              device, stream);
}

int stencil_tiled_f32(const void* x, void* y, int nvec, long long ldx,
                      long long ldy, long long n, int ndiag,
                      const long long* offsets, const double* consts,
                      long long grid_c, const void* top, const void* bot,
                      const void* left, const void* right, const int* plan,
                      int device, void* stream) {
  return launch_tiled<float>(x, y, nvec, ldx, ldy, n, ndiag, offsets,
                             consts, grid_c, top, bot, left, right, plan,
                             device, stream);
}

}  // extern "C"

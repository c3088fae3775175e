// DIA sparse matrix-vector product for Hopper (sm_90a), f64 and f32, that
// reads only the live segments of the diagonals.
//
//   y[i] = sum_d data[d, i] * x[i + off_d]
//
// A third, mixed instantiation reads f32 data and x and forms f64 products
// and sums into an f64 y (dia_spmv_mixed): the f32 storage mode's
// certificates and f64 constraint reductions, where the JAX package
// evaluates the same sum in double-f32 pairs (ops/dd.py::spmv_dia).  An f32
// by f32 product is exact in f64, so each term is exact and only the f64
// sum rounds.
// with the column taken mod n (periodic meshes, `wrap`) or treated as a
// structural zero when it falls outside [0, n).  `data` is row-aligned:
// data[d, i] holds A[i, i + off_d], stored (ndiag, n) row-major.
//
// Replaces the TPU kernel ops/pallas_spmv.py::dia_spmv_pallas of the JAX
// package.  That kernel views x as (rows, 128) lanes and hands every program
// a padded halo table of (lo + hi) / 128 + 2 sublanes; the layout exists for
// Mosaic's tiling rules, and at the shallow-water operator's offsets
// (+-263,167 of n = 786,432) each halo is about two thirds of x.  None of
// that is carried over.
//
// What bounds it: the bytes of the live segments.  A DIA stores every
// diagonal over every row, but an operator need not use them so: the
// shallow-water operator couples its three C-grid fields (u, v, rho) through
// different subsets of its 21 offsets, so 70% of `data` is exact zeros (6.33
// non-zeros a row).  Reading every diagonal moves (ndiag + 2) * n *
// sizeof(T), 145 MB at swe M=512 in f64; the operator's non-zeros with x and
// y are 52 MB.  x is read once per live diagonal, but from contiguous
// shifted runs that after the first touch come from L2 (6.3 MB against a
// 50 MB L2).
//
// What the design does about it: the live plan.  The rows are cut into
// chunks of 2^chunk_shift rows, and one 64-bit word per chunk (`live`,
// built once per operator on the device, kernels/dia_spmv.py::live_plan)
// has bit d set where data[d, chunk] holds any non-zero; DIA_MAX_DIAGS is 64,
// so a word always suffices.  A warp takes 32 * RPT consecutive rows (RPT =
// 16 / sizeof(T): one 16-byte load of a diagonal per thread), which lie in
// one chunk, reads the chunk's word, and walks its set bits in ascending d,
// DIA_BATCH at a time: the loop is uniform across the warp, and a batch's
// loads are all in flight before its multiply-adds.  Coefficients are read
// with the evict-first hint (__ldcs), so single-use coefficients do not push
// x out of L2; x is read through the read-only path (__ldg).  Where n is a
// multiple of RPT and `data` is 16-byte aligned, a thread reads its RPT
// consecutive rows of a diagonal as one vector; otherwise each of its RPT
// loads is a coalesced scalar load, 32 apart.  A null `live` runs the same
// kernel with every bit set: the dense read of the first design.  The host
// launches it so for an operator whose plan would skip less than a tenth of
// its coefficients (heat's, live but at the boundary rows): there the
// word's dependent load costs more than the skipped bytes save
// (kernels/dia_spmv.py::LIVE_MIN_SKIP).
//
// Semantics.  Each row sums its live diagonals in ascending d, with the
// fused multiply-adds of the dense design, and the out-of-range mask is
// applied even where the coefficient is non-zero, so a padding slot never
// reads past x.  A skipped term has a coefficient that is exactly 0 over its
// whole chunk, so for finite x the result is the dense design's bit for bit
// (up to the sign of a zero).  An Inf or NaN of x that only skipped zero
// coefficients read no longer reaches y, as in a CSR product; the plain
// PyTorch twin multiplies every diagonal.  Index arithmetic is 64-bit and
// offsets are signed.
//
// The windowed launch (wrap = DIA_EDGE_WINDOW) is the local product of a
// row-sharded operator (parallel/sharded.py): n is the shard's rows, x a
// window of the columns they read, assembled by the exchange with the other
// ranks, and each row sums the same live diagonals in the same order as the
// unsharded launch, so on one rank it gives the unsharded product's bits.

#include "dia_row.cuh"

// live diagonals whose loads a warp issues before their multiply-adds:
// four measured faster than eight on an H100 at both main-path operators
// (swe M=512, heat M=1024), the registers of eight costing resident warps
#define DIA_BATCH 4

// a thread's RPT consecutive rows of y as 16-byte stores: one vector of T,
// or, for the mixed form (RPT = 4 f32 rows, 32 bytes of f64), two double2
template <typename T, int RPT>
__device__ __forceinline__ void store_rows(T* y, const T (&acc)[RPT]) {
  *reinterpret_cast<typename Vec16<T>::type*>(y) = Vec16<T>::join(acc);
}
template <>
__device__ __forceinline__ void store_rows<double, 4>(double* y,
                                                      const double (&acc)[4]) {
  reinterpret_cast<double2*>(y)[0] = make_double2(acc[0], acc[1]);
  reinterpret_cast<double2*>(y)[1] = make_double2(acc[2], acc[3]);
}

// VEC: thread t of a warp holds rows w0 + RPT t + k (n % RPT == 0, so all
// or none of them exist); otherwise rows w0 + t + 32 k.  Acc: the type of
// the products, the sums and y (T, or double for f32 T: the mixed form)
template <typename T, typename Acc, int EDGE, bool VEC>
__global__ void __launch_bounds__(DIA_THREADS)
    dia_spmv_kernel(const T* __restrict__ data, const T* __restrict__ x,
                    Acc* __restrict__ y, long long n, int ndiag,
                    const unsigned long long* __restrict__ live,
                    int chunk_shift, const __grid_constant__ DiaOffsets offs) {
  constexpr int RPT = 16 / sizeof(T);
  constexpr int WARP_ROWS = 32 * RPT;
  const int lane = threadIdx.x & 31;
  const long long w0 =
      ((long long)blockIdx.x * (DIA_THREADS / 32) + (threadIdx.x >> 5)) *
      WARP_ROWS;
  if (w0 >= n) return;
  long long row[RPT];
  bool in[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    row[k] = VEC ? w0 + RPT * lane + k : w0 + lane + 32 * k;
    in[k] = row[k] < n;
  }
  const unsigned long long all =
      ndiag >= 64 ? ~0ULL : ((1ULL << ndiag) - 1ULL);
  unsigned long long m = live ? (__ldg(live + (w0 >> chunk_shift)) & all) : all;
  Acc acc[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) acc[k] = Acc(0);
  while (m) {
    int dd[DIA_BATCH];
#pragma unroll
    for (int u = 0; u < DIA_BATCH; ++u) {
      dd[u] = m ? __ffsll((long long)m) - 1 : -1;
      m &= m - 1ULL;  // stays 0 once empty
    }
    T a[DIA_BATCH][RPT], xv[DIA_BATCH][RPT];
#pragma unroll
    for (int u = 0; u < DIA_BATCH; ++u) {
      if (dd[u] < 0) continue;
      const T* drow = data + (long long)dd[u] * n;
      const long long off = offs.off[dd[u]];
      if (VEC) {
        using V = typename Vec16<T>::type;
        if (in[0]) Vec16<T>::split(__ldcs(reinterpret_cast<const V*>(drow + row[0])), a[u]);
      } else {
#pragma unroll
        for (int k = 0; k < RPT; ++k) a[u][k] = in[k] ? __ldcs(drow + row[k]) : T(0);
      }
#pragma unroll
      for (int k = 0; k < RPT; ++k)
        xv[u][k] = in[k] ? x_at<T, EDGE>(x, row[k] + off, n) : T(0);
    }
#pragma unroll
    for (int u = 0; u < DIA_BATCH; ++u) {
      if (dd[u] < 0) continue;
#pragma unroll
      for (int k = 0; k < RPT; ++k) acc[k] += Acc(a[u][k]) * Acc(xv[u][k]);
    }
  }
  if (VEC) {
    if (in[0]) store_rows(y + row[0], acc);
  } else {
#pragma unroll
    for (int k = 0; k < RPT; ++k)
      if (in[k]) y[row[k]] = acc[k];
  }
}

template <typename T, typename Acc, int EDGE, bool VEC>
static void run(const void* data, const void* x, void* y, long long n,
                int ndiag, const unsigned long long* live, int chunk_shift,
                const DiaOffsets& offs, long long blocks, cudaStream_t s) {
  dia_spmv_kernel<T, Acc, EDGE, VEC><<<(unsigned)blocks, DIA_THREADS, 0, s>>>(
      (const T*)data, (const T*)x, (Acc*)y, n, ndiag, live, chunk_shift, offs);
}

// live: one word per chunk of 2^chunk_shift rows, or null for every
// diagonal; a chunk holds whole warps (checked here).  wrap: DIA_EDGE_*;
// with DIA_EDGE_WINDOW, x points at the window's column 0 (the caller's
// base), and columns -lo .. n + hi - 1 of it are read
template <typename T, typename Acc = T>
static int launch(const void* data, const void* x, void* y, long long n,
                  int ndiag, const long long* offsets, int wrap,
                  const void* live, int chunk_shift, int device,
                  void* stream) {
  constexpr int RPT = 16 / sizeof(T);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ndiag < 0 || ndiag > DIA_MAX_DIAGS || n < 1)
    return (int)cudaErrorInvalidValue;
  if (live && (chunk_shift < 0 || chunk_shift > 40 ||
               (1LL << chunk_shift) % (32 * RPT) != 0))
    return (int)cudaErrorInvalidValue;
  DiaOffsets offs;
  for (int d = 0; d < DIA_MAX_DIAGS; ++d) offs.off[d] = d < ndiag ? offsets[d] : 0;
  const long long block_rows = (long long)DIA_THREADS * RPT;
  const long long blocks = (n + block_rows - 1) / block_rows;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec = n % RPT == 0 && (uintptr_t)data % 16 == 0 &&
                   (uintptr_t)y % 16 == 0;
  const auto* words = (const unsigned long long*)live;
  cudaStream_t s = (cudaStream_t)stream;
  switch (wrap) {
    case DIA_EDGE_ZERO:
      if (vec) run<T, Acc, DIA_EDGE_ZERO, true>(data, x, y, n, ndiag, words, chunk_shift, offs, blocks, s);
      else run<T, Acc, DIA_EDGE_ZERO, false>(data, x, y, n, ndiag, words, chunk_shift, offs, blocks, s);
      break;
    case DIA_EDGE_WRAP:
      if (vec) run<T, Acc, DIA_EDGE_WRAP, true>(data, x, y, n, ndiag, words, chunk_shift, offs, blocks, s);
      else run<T, Acc, DIA_EDGE_WRAP, false>(data, x, y, n, ndiag, words, chunk_shift, offs, blocks, s);
      break;
    case DIA_EDGE_WINDOW:
      if (vec) run<T, Acc, DIA_EDGE_WINDOW, true>(data, x, y, n, ndiag, words, chunk_shift, offs, blocks, s);
      else run<T, Acc, DIA_EDGE_WINDOW, false>(data, x, y, n, ndiag, words, chunk_shift, offs, blocks, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" {

int dia_spmv_f64(const void* data, const void* x, void* y, long long n,
                 int ndiag, const long long* offsets, int wrap,
                 const void* live, int chunk_shift, int device,
                 void* stream) {
  return launch<double>(data, x, y, n, ndiag, offsets, wrap, live,
                        chunk_shift, device, stream);
}

int dia_spmv_f32(const void* data, const void* x, void* y, long long n,
                 int ndiag, const long long* offsets, int wrap,
                 const void* live, int chunk_shift, int device,
                 void* stream) {
  return launch<float>(data, x, y, n, ndiag, offsets, wrap, live,
                       chunk_shift, device, stream);
}

// f32 data and x, f64 y: the mixed form
int dia_spmv_mixed(const void* data, const void* x, void* y, long long n,
                   int ndiag, const long long* offsets, int wrap,
                   const void* live, int chunk_shift, int device,
                   void* stream) {
  return launch<float, double>(data, x, y, n, ndiag, offsets, wrap, live,
                               chunk_shift, device, stream);
}

}  // extern "C"

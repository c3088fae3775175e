// DIA sparse matrix product with a block of vectors for Hopper (sm_90a), f64
// and f32: B vectors that share one operator, each coefficient read once
// for a tile of TB of them.
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
// What bounds it: bytes.  The operator's stored non-zeros are read once for
// the block and the B vectors are read and written once each: at swe M=512
// (6.33 non-zeros a row, n = 786,432) with B = 8 that is 39.8 MB of
// coefficients and 100.7 MB of vectors, 0.0419 ms at 3.35 TB/s, where B
// launches of kernel #1 move 8 x 52.4 MB.  The multiply-adds (2 x 6.33 x B
// a row) are far below the f64 rate.
//
// What the design does about it.  The rows are laid out as in kernel #1: a
// warp takes 32 * RPT consecutive rows (RPT = 16 / sizeof(T)), which lie in
// one chunk of the live plan, reads the chunk's word and walks its set bits
// in ascending d.  For each live diagonal a thread loads its RPT
// coefficients once (16 bytes, evict-first), then x at its rows for each of
// the TB vectors of the tile, and does TB x RPT multiply-adds into
// registers: the TB x RPT loads of x are independent and in flight
// together, so one diagonal at a time keeps the memory system busy.  The
// vectors are taken TB at a time (TB = 4 or 8, a template argument; the
// registers of the accumulators and the loads decide which is faster, so
// the wrapper's choice is measured, kernels/dia_spmv.py::spmm_tile); a
// block of more than TB vectors re-reads the chunk's coefficients once a
// tile, from L1 or L2.  A null plan reads every diagonal (the dense design).
// In f64 a tile of 8 takes 105 registers a thread, two blocks of 256 an SM:
// the kernel reaches 44% of its bound at B = 8 on an H100 (PERF.md §6).
//
// Semantics: each (row, vector) sums its live diagonals in ascending d with
// fused multiply-adds, as kernel #1 does, so column b of the product is
// kernel #1's product of vector b bit for bit.  Index arithmetic is 64-bit.

#include "dia_row.cuh"

// VEC: thread t of a warp holds rows w0 + RPT t + k (n % RPT == 0, so all
// or none of them exist); otherwise rows w0 + t + 32 k
template <typename T, bool WRAP, bool VEC, int TB>
__global__ void __launch_bounds__(DIA_THREADS)
    dia_spmm_kernel(const T* __restrict__ data, const T* __restrict__ x,
                    T* __restrict__ y, long long n, long long nvec,
                    long long ldx, long long ldy, int ndiag,
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
  const unsigned long long word =
      live ? (__ldg(live + (w0 >> chunk_shift)) & all) : all;
  for (long long b0 = 0; b0 < nvec; b0 += TB) {
    const int nb = (int)(nvec - b0 < TB ? nvec - b0 : TB);
    const T* xt = x + b0 * ldx;
    T acc[TB][RPT];
#pragma unroll
    for (int t = 0; t < TB; ++t)
#pragma unroll
      for (int k = 0; k < RPT; ++k) acc[t][k] = T(0);
    unsigned long long m = word;
    while (m) {
      const int d = __ffsll((long long)m) - 1;
      m &= m - 1ULL;
      const T* drow = data + (long long)d * n;
      const long long off = offs.off[d];
      T a[RPT];
      if (VEC) {
        using V = typename Vec16<T>::type;
        if (in[0]) Vec16<T>::split(__ldcs(reinterpret_cast<const V*>(drow + row[0])), a);
      } else {
#pragma unroll
        for (int k = 0; k < RPT; ++k) a[k] = in[k] ? __ldcs(drow + row[k]) : T(0);
      }
      T xv[TB][RPT];
#pragma unroll
      for (int t = 0; t < TB; ++t)
#pragma unroll
        for (int k = 0; k < RPT; ++k)
          xv[t][k] = (t < nb && in[k])
                         ? x_at<T, WRAP>(xt + t * ldx, row[k] + off, n)
                         : T(0);
#pragma unroll
      for (int t = 0; t < TB; ++t)
#pragma unroll
        for (int k = 0; k < RPT; ++k) acc[t][k] += a[k] * xv[t][k];
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

template <typename T, bool WRAP, bool VEC, int TB>
static void run(const void* data, const void* x, void* y, long long n,
                long long nvec, long long ldx, long long ldy, int ndiag,
                const unsigned long long* live, int chunk_shift,
                const DiaOffsets& offs, long long blocks, cudaStream_t s) {
  dia_spmm_kernel<T, WRAP, VEC, TB><<<(unsigned)blocks, DIA_THREADS, 0, s>>>(
      (const T*)data, (const T*)x, (T*)y, n, nvec, ldx, ldy, ndiag, live,
      chunk_shift, offs);
}

template <typename T, int TB>
static void dispatch(bool wrap, bool vec, const void* data, const void* x,
                     void* y, long long n, long long nvec, long long ldx,
                     long long ldy, int ndiag, const unsigned long long* live,
                     int chunk_shift, const DiaOffsets& offs, long long blocks,
                     cudaStream_t s) {
  if (wrap) {
    if (vec) run<T, true, true, TB>(data, x, y, n, nvec, ldx, ldy, ndiag, live, chunk_shift, offs, blocks, s);
    else run<T, true, false, TB>(data, x, y, n, nvec, ldx, ldy, ndiag, live, chunk_shift, offs, blocks, s);
  } else {
    if (vec) run<T, false, true, TB>(data, x, y, n, nvec, ldx, ldy, ndiag, live, chunk_shift, offs, blocks, s);
    else run<T, false, false, TB>(data, x, y, n, nvec, ldx, ldy, ndiag, live, chunk_shift, offs, blocks, s);
  }
}

// live: one word per chunk of 2^chunk_shift rows, or null for every
// diagonal; a chunk holds whole warps (checked here); tile: 4 or 8
template <typename T>
static int launch(const void* data, const void* x, void* y, long long n,
                  long long nvec, long long ldx, long long ldy, int ndiag,
                  const long long* offsets, int wrap, const void* live,
                  int chunk_shift, int tile, int device, void* stream) {
  constexpr int RPT = 16 / sizeof(T);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ndiag < 0 || ndiag > DIA_MAX_DIAGS || n < 1 || nvec < 1 ||
      (nvec > 1 && (ldx < n || ldy < n)) || (tile != 4 && tile != 8))
    return (int)cudaErrorInvalidValue;
  if (live && (chunk_shift < 0 || chunk_shift > 40 ||
               (1LL << chunk_shift) % (32 * RPT) != 0))
    return (int)cudaErrorInvalidValue;
  DiaOffsets offs;
  for (int d = 0; d < DIA_MAX_DIAGS; ++d) offs.off[d] = d < ndiag ? offsets[d] : 0;
  const long long block_rows = (long long)DIA_THREADS * RPT;
  const long long blocks = (n + block_rows - 1) / block_rows;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec = n % RPT == 0 && (nvec == 1 || ldy % RPT == 0) &&
                   (uintptr_t)data % 16 == 0 && (uintptr_t)y % 16 == 0;
  const auto* words = (const unsigned long long*)live;
  cudaStream_t s = (cudaStream_t)stream;
  if (tile == 8)
    dispatch<T, 8>(wrap, vec, data, x, y, n, nvec, ldx, ldy, ndiag, words, chunk_shift, offs, blocks, s);
  else
    dispatch<T, 4>(wrap, vec, data, x, y, n, nvec, ldx, ldy, ndiag, words, chunk_shift, offs, blocks, s);
  return (int)cudaGetLastError();
}

extern "C" {

int dia_spmm_f64(const void* data, const void* x, void* y, long long n,
                 long long nvec, long long ldx, long long ldy, int ndiag,
                 const long long* offsets, int wrap, const void* live,
                 int chunk_shift, int tile, int device, void* stream) {
  return launch<double>(data, x, y, n, nvec, ldx, ldy, ndiag, offsets, wrap,
                        live, chunk_shift, tile, device, stream);
}

int dia_spmm_f32(const void* data, const void* x, void* y, long long n,
                 long long nvec, long long ldx, long long ldy, int ndiag,
                 const long long* offsets, int wrap, const void* live,
                 int chunk_shift, int tile, int device, void* stream) {
  return launch<float>(data, x, y, n, nvec, ldx, ldy, ndiag, offsets, wrap,
                       live, chunk_shift, tile, device, stream);
}

}  // extern "C"

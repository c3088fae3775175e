// Constant-stencil SpMV with its boundary-strip correction, for Hopper
// (sm_90a), f64 and f32.
//
//   y[i] = sum_d c_d * x[i + off_d]  +  E[i, :] x
//
// The row arithmetic, and the layout of the strips (the residuals of a
// structured-grid operator against its constants on the boundary rows and
// columns of the (R, C) grid view, C = grid_c), are in stencil_row.cuh,
// which the fused polynomial applies of poly_apply.cu share.  grid_c == 0
// means no strips (an exactly constant operator, possibly periodic); strips
// never come with wrap.
//
// Replaces the TPU kernel ops/pallas_spmv.py::stencil_spmv_pallas of the JAX
// package, together with the separate strip pass ops/stencil.py::
// _apply_strips that follows it there.  The Pallas kernel rotates a
// (rows, 128)-lane view of x with a halo per program; that layout serves the
// TPU's vector unit and is not carried over.
//
// What bounds it: bytes.  No coefficient row is read: the work per row is
// ndiag multiply-adds against ndiag reads of x, which after the first touch
// come from L2 (x is 8.4 MB in f64 at heat M=1024, n = 1,050,625, against a
// 50 MB L2).  Device-memory traffic is x once and y once, 2 * n * sizeof(T),
// plus the strips, 2 * (C + R) * ndiag * sizeof(T) -- about 17 MB per f64
// product at heat M=1024, 0.4 flop per byte.
//
// What the design does about it: one thread per row in a grid-stride loop,
// so a warp reads 32 consecutive entries of x at each shift (coalesced) and
// writes 32 consecutive results.  Constants and offsets travel by value in
// the kernel's parameter block, so no thread loads them.  The strip test is
// one 64-bit division per row; only the O(R + C) strip rows read strip
// data.  Index arithmetic is 64-bit and offsets are signed.  Shared-memory
// tiling, vector loads and TMA are left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stencil_row.cuh"

template <typename T, bool WRAP>
__global__ void stencil_spmv_kernel(const T* __restrict__ x,
                                    T* __restrict__ y, long long n,
                                    int ndiag, StencilParams<T> p,
                                    long long C, long long R,
                                    const T* __restrict__ top,
                                    const T* __restrict__ bot,
                                    const T* __restrict__ left,
                                    const T* __restrict__ right) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const ReadOnlyLoad<T> ld{x};
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    y[i] = stencil_row<T, WRAP>(ld, i, n, ndiag, p, C, R, top, bot, left,
                                right);
  }
}

template <typename T>
static int launch(const void* x, void* y, long long n, int ndiag,
                  const long long* offsets, const double* consts, int wrap,
                  long long grid_c, const void* top, const void* bot,
                  const void* left, const void* right, int device,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ndiag < 0 || ndiag > STENCIL_MAX_DIAGS) return (int)cudaErrorInvalidValue;
  if (grid_c < 0 || (grid_c > 0 && (wrap || n % grid_c != 0)))
    return (int)cudaErrorInvalidValue;
  StencilParams<T> p;
  for (int d = 0; d < STENCIL_MAX_DIAGS; ++d) {
    p.off[d] = d < ndiag ? offsets[d] : 0;
    p.c[d] = d < ndiag ? (T)consts[d] : T(0);
  }
  const long long R = grid_c > 0 ? n / grid_c : 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 8192) blocks = 8192;  // grid-stride loop covers the rest
  if (blocks < 1) blocks = 1;
  cudaStream_t s = (cudaStream_t)stream;
  if (wrap) {
    stencil_spmv_kernel<T, true><<<(unsigned)blocks, threads, 0, s>>>(
        (const T*)x, (T*)y, n, ndiag, p, 0, 0, nullptr, nullptr, nullptr,
        nullptr);
  } else {
    stencil_spmv_kernel<T, false><<<(unsigned)blocks, threads, 0, s>>>(
        (const T*)x, (T*)y, n, ndiag, p, grid_c, R, (const T*)top,
        (const T*)bot, (const T*)left, (const T*)right);
  }
  return (int)cudaGetLastError();
}

extern "C" {

int stencil_spmv_f64(const void* x, void* y, long long n, int ndiag,
                     const long long* offsets, const double* consts, int wrap,
                     long long grid_c, const void* top, const void* bot,
                     const void* left, const void* right, int device,
                     void* stream) {
  return launch<double>(x, y, n, ndiag, offsets, consts, wrap, grid_c, top,
                        bot, left, right, device, stream);
}

int stencil_spmv_f32(const void* x, void* y, long long n, int ndiag,
                     const long long* offsets, const double* consts, int wrap,
                     long long grid_c, const void* top, const void* bot,
                     const void* left, const void* right, int device,
                     void* stream) {
  return launch<float>(x, y, n, ndiag, offsets, consts, wrap, grid_c, top,
                       bot, left, right, device, stream);
}

}  // extern "C"

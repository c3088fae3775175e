// Constant-stencil SpMV with its boundary-strip correction, for Hopper
// (sm_90a), f64 and f32.
//
//   y[i] = sum_d c_d * x[i + off_d]  +  E[i, :] x
//
// The shifted reads of x are flat: the column i + off_d is taken mod n when
// `wrap` is set, and is a structural zero outside [0, n) otherwise.  E is the
// residual of a structured-grid operator against its constants, and lives
// only on the boundary strips of the (R, C) grid view of the flat index
// (C = grid_c, R = n / C):
//
//   rows [0, C)           top[d, i]            (ndiag, C)
//   rows [n - C, n)       bot[d, i - (n - C)]  (ndiag, C)
//   rows with i % C == 0      left[d, i / C]   (ndiag, R)
//   rows with i % C == C - 1  right[d, i / C]  (ndiag, R)
//
// Each residual term reads the same flat shifted x as the constant part, so
// the left and right strips cancel what the +-1 diagonals read across the
// ends of a grid row.  left and right hold zeros at grid rows 0 and R - 1,
// which the top and bottom strips cover, so adding every strip that holds a
// row is right at the corners too.  grid_c == 0 means no strips (an exactly
// constant operator, possibly periodic); strips never come with wrap.
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

#define STENCIL_MAX_DIAGS 64

template <typename T>
struct StencilParams {
  long long off[STENCIL_MAX_DIAGS];
  T c[STENCIL_MAX_DIAGS];
};

template <typename T, bool WRAP>
__device__ __forceinline__ T shifted(const T* __restrict__ x, long long j,
                                     long long n) {
  // |off| < n is checked by the caller, so one add or subtract brings a
  // wrapped column back into range
  if (WRAP) {
    if (j < 0) j += n;
    else if (j >= n) j -= n;
    return x[j];
  }
  return (j >= 0 && j < n) ? x[j] : T(0);
}

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
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    T acc = T(0);
    for (int d = 0; d < ndiag; ++d) {
      acc += p.c[d] * shifted<T, WRAP>(x, i + p.off[d], n);
    }
    if (C > 0) {
      const long long r = i / C;
      const long long col = i - r * C;
      const bool in_top = i < C;
      const bool in_bot = i >= n - C;
      const bool in_left = col == 0;
      const bool in_right = col == C - 1;
      if (in_top || in_bot || in_left || in_right) {
        // the four strip sums apart, then added in the plain version's
        // order: ((top + bot) + left) + right
        T t = T(0), b = T(0), l = T(0), rt = T(0);
        for (int d = 0; d < ndiag; ++d) {
          const T xv = shifted<T, WRAP>(x, i + p.off[d], n);
          if (in_top) t += top[(long long)d * C + i] * xv;
          if (in_bot) b += bot[(long long)d * C + (i - (n - C))] * xv;
          if (in_left) l += left[(long long)d * R + r] * xv;
          if (in_right) rt += right[(long long)d * R + r] * xv;
        }
        acc = acc + (((t + b) + l) + rt);
      }
    }
    y[i] = acc;
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

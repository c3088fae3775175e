// DIA sparse matrix-vector product for Hopper (sm_90a), f64 and f32.
//
//   y[i] = sum_d data[d, i] * x[i + off_d]
//
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
// What bounds it: bytes.  Each row reads ndiag coefficients and writes one
// result; x is read ndiag times but from ndiag contiguous shifted runs, so
// after the first touch it is served by L2 (x is 6.3 MB in f64 at n =
// 786,432, against a 50 MB L2).  Device-memory traffic is therefore about
// (ndiag + 2) * n * sizeof(T): 145 MB per product for the 21-diagonal
// shallow-water operator in f64, 0.2 flop per byte, far below the card's
// balance point.
//
// What the design does about it: one thread per row in a grid-stride loop,
// so a warp reads 32 consecutive coefficients of one diagonal (coalesced)
// and 32 consecutive entries of x at one shift.  Offsets travel by value in
// the kernel's parameter block, so no thread loads an index.  Index
// arithmetic is 64-bit and offsets are signed; the out-of-range mask is
// applied even where the coefficient is zero, so an Inf or NaN in x never
// leaks through a padding slot.  Shared-memory tiling, vector loads and TMA
// are left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define DIA_MAX_DIAGS 64

struct DiaOffsets {
  long long off[DIA_MAX_DIAGS];
};

template <typename T, bool WRAP>
__global__ void dia_spmv_kernel(const T* __restrict__ data,
                                const T* __restrict__ x,
                                T* __restrict__ y,
                                long long n, int ndiag, DiaOffsets offs) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    T acc = T(0);
    for (int d = 0; d < ndiag; ++d) {
      // |off| < n is checked by the caller, so one add or subtract
      // brings a wrapped column back into range.
      long long j = i + offs.off[d];
      T xv;
      if (WRAP) {
        if (j < 0) j += n;
        else if (j >= n) j -= n;
        xv = x[j];
      } else {
        xv = (j >= 0 && j < n) ? x[j] : T(0);
      }
      acc += data[(long long)d * n + i] * xv;
    }
    y[i] = acc;
  }
}

template <typename T>
static int launch(const void* data, const void* x, void* y, long long n,
                  int ndiag, const long long* offsets, int wrap, int device,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ndiag < 0 || ndiag > DIA_MAX_DIAGS) return (int)cudaErrorInvalidValue;
  DiaOffsets offs;
  for (int d = 0; d < DIA_MAX_DIAGS; ++d) offs.off[d] = d < ndiag ? offsets[d] : 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 8192) blocks = 8192;  // grid-stride loop covers the rest
  if (blocks < 1) blocks = 1;
  cudaStream_t s = (cudaStream_t)stream;
  if (wrap) {
    dia_spmv_kernel<T, true><<<(unsigned)blocks, threads, 0, s>>>(
        (const T*)data, (const T*)x, (T*)y, n, ndiag, offs);
  } else {
    dia_spmv_kernel<T, false><<<(unsigned)blocks, threads, 0, s>>>(
        (const T*)data, (const T*)x, (T*)y, n, ndiag, offs);
  }
  return (int)cudaGetLastError();
}

extern "C" {

int dia_spmv_f64(const void* data, const void* x, void* y, long long n,
                 int ndiag, const long long* offsets, int wrap, int device,
                 void* stream) {
  return launch<double>(data, x, y, n, ndiag, offsets, wrap, device, stream);
}

int dia_spmv_f32(const void* data, const void* x, void* y, long long n,
                 int ndiag, const long long* offsets, int wrap, int device,
                 void* stream) {
  return launch<float>(data, x, y, n, ndiag, offsets, wrap, device, stream);
}

}  // extern "C"

// The row code that the DIA kernels share (csrc/dia_spmv.cu, one vector;
// csrc/dia_spmm.cu, a block of vectors): the offsets as a kernel argument,
// the 16-byte vectors of a thread's rows, and x at a column of a row,
// wrapped, zero-filled or read from a window.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define DIA_MAX_DIAGS 64
#define DIA_THREADS 256

// what a column outside [0, n) reads (the `wrap` argument of the entry
// points): 0 zero, 1 the column mod n (periodic meshes), 2 the window, x
// then being a window of the columns a shard's rows read (its rows' own and
// the halos), held from the caller's base, so that every column a row reads
// lies in it (parallel/sharded.py builds the window; no test per element)
#define DIA_EDGE_ZERO 0
#define DIA_EDGE_WRAP 1
#define DIA_EDGE_WINDOW 2

struct DiaOffsets {
  long long off[DIA_MAX_DIAGS];
};

// a 16-byte vector of T, and its RPT lanes
template <typename T>
struct Vec16;
template <>
struct Vec16<double> {
  using type = double2;
  __device__ static void split(const double2& v, double (&a)[2]) {
    a[0] = v.x;
    a[1] = v.y;
  }
  __device__ static double2 join(const double (&a)[2]) {
    return make_double2(a[0], a[1]);
  }
};
template <>
struct Vec16<float> {
  using type = float4;
  __device__ static void split(const float4& v, float (&a)[4]) {
    a[0] = v.x;
    a[1] = v.y;
    a[2] = v.z;
    a[3] = v.w;
  }
  __device__ static float4 join(const float (&a)[4]) {
    return make_float4(a[0], a[1], a[2], a[3]);
  }
};

// x at column j of a row of the operator: wrapped mod n, 0 outside [0, n),
// or read from the window as it is
template <typename T, int EDGE>
__device__ __forceinline__ T x_at(const T* __restrict__ x, long long j,
                                  long long n) {
  // |off| < n is checked by the caller, so one add or subtract brings a
  // wrapped column back into range
  if (EDGE == DIA_EDGE_WINDOW) return __ldg(x + j);
  if (EDGE == DIA_EDGE_WRAP) {
    if (j < 0) j += n;
    else if (j >= n) j -= n;
    return __ldg(x + j);
  }
  return (j >= 0 && j < n) ? __ldg(x + j) : T(0);
}

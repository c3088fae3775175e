// One row of a constant-stencil product with its boundary-strip correction,
// shared by csrc/stencil_spmv.cu (one product), csrc/poly_apply.cu (the
// fused polynomial applies, p flat products in one launch) and
// csrc/poly_tiled.cu (the same applies on 2-D tiles in shared memory).
//
//   (A x)[i] = sum_d c_d * x[i + off_d]  +  E[i, :] x
//
// The shifted reads of x are flat: the column i + off_d is taken mod n when
// `WRAP` is set, and is a structural zero outside [0, n) otherwise.  E is the
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
// row is right at the corners too.  C == 0 means no strips (an exactly
// constant operator, possibly periodic); strips never come with wrap.
//
// x is read through a loader, `ld(j)` for an in-range column j, so that a
// caller can read a vector that it scales on the fly (x = v / theta) with the
// same arithmetic as if it had stored the scaled vector first.

#pragma once

#include <cuda_runtime.h>

#define STENCIL_MAX_DIAGS 64

template <typename T>
struct StencilParams {
  long long off[STENCIL_MAX_DIAGS];
  T c[STENCIL_MAX_DIAGS];
};

// x[j] of a vector that no thread writes during the launch: the read-only
// data path may serve it
template <typename T>
struct ReadOnlyLoad {
  const T* x;
  __device__ __forceinline__ T operator()(long long j) const {
    return __ldg(x + j);
  }
};

// x[j] of a vector that threads of the same launch wrote before a grid-wide
// barrier: a plain, coherent load (the read-only path may serve stale lines)
template <typename T>
struct CoherentLoad {
  const T* x;
  __device__ __forceinline__ T operator()(long long j) const { return x[j]; }
};

template <typename T, bool WRAP, class L>
__device__ __forceinline__ T shifted(const L& ld, long long j,
                                     long long n) {
  // |off| < n is checked by the caller, so one add or subtract brings a
  // wrapped column back into range
  if (WRAP) {
    if (j < 0) j += n;
    else if (j >= n) j -= n;
    return ld(j);
  }
  return (j >= 0 && j < n) ? ld(j) : T(0);
}

// The product at row i, which lies at column `col` of grid row `r`
// (i = r C + col; unread when C == 0), with xv(d) the shifted value
// x[i + off_d] of diagonal d: the constant chain in diagonal order, then, on
// a strip row, the four strip sums apart, added in the plain version's
// order: ((top + bot) + left) + right.  Only the O(R + C) strip rows read
// strip data.  A caller that knows r and col (a tile of the grid) passes
// them; stencil_row derives them from the flat index.
template <typename T, class XV>
__device__ __forceinline__ T stencil_sum(
    const XV& xv, long long i, long long r, long long col, long long n,
    int ndiag, const StencilParams<T>& p, long long C, long long R,
    const T* __restrict__ top, const T* __restrict__ bot,
    const T* __restrict__ left, const T* __restrict__ right) {
  T acc = T(0);
  for (int d = 0; d < ndiag; ++d) {
    acc += p.c[d] * xv(d);
  }
  if (C > 0) {
    const bool in_top = i < C;
    const bool in_bot = i >= n - C;
    const bool in_left = col == 0;
    const bool in_right = col == C - 1;
    if (in_top || in_bot || in_left || in_right) {
      T t = T(0), b = T(0), l = T(0), rt = T(0);
      for (int d = 0; d < ndiag; ++d) {
        const T x = xv(d);
        if (in_top) t += top[(long long)d * C + i] * x;
        if (in_bot) b += bot[(long long)d * C + (i - (n - C))] * x;
        if (in_left) l += left[(long long)d * R + r] * x;
        if (in_right) rt += right[(long long)d * R + r] * x;
      }
      acc = acc + (((t + b) + l) + rt);
    }
  }
  return acc;
}

// stencil_sum at flat row i, reading x[i + off_d] through the loader; the
// strip test costs one 64-bit division per row
template <typename T, bool WRAP, class L>
__device__ __forceinline__ T stencil_row(
    const L& ld, long long i, long long n, int ndiag,
    const StencilParams<T>& p, long long C, long long R,
    const T* __restrict__ top, const T* __restrict__ bot,
    const T* __restrict__ left, const T* __restrict__ right) {
  const auto xv = [&](int d) { return shifted<T, WRAP>(ld, i + p.off[d], n); };
  const long long r = C > 0 ? i / C : 0;
  return stencil_sum<T>(xv, i, r, i - r * C, n, ndiag, p, C, R, top, bot,
                        left, right);
}

// Fused polynomial preconditioner applies on 2-D tiles for Hopper (sm_90a),
// f64 and f32: the degree-p Chebyshev and truncated Neumann recurrences,
// p(A) v, for a constant stencil with boundary strips (stencil_row.cuh) on
// an (R, C) grid whose offsets, in ascending order, all lie in the 3 x 3
// box of one grid row and one grid column (heat's seven-point stencil), in
// one launch each.  The recurrences, their scalars and their roundings are
// those of csrc/poly_apply.cu, which keeps the flat design for every other
// operator (the DIA form, a stencil without a grid or beyond the box) and
// for a degree whose halo no tile holds.
//
// Replaces the TPU kernels ops/pallas_poly.py::cheb_apply_fused and
// ::neumann_apply_fused of the JAX package.  Like them it time-tiles the
// recurrence: a block loads a window of v and runs all p steps on chip.  The
// TPU kernel's window is flat, R + 2 p span rows; at heat's span (1026) that
// is 16 K rows a side, which shared memory cannot hold.  Here the window is a
// tile in two dimensions of the grid.
//
// What bounds it: the ideal reads v once (and D^-1 for Neumann, and the
// strips) and writes y once, 17 MB at heat M=1024 in f64; the tiles' halos
// read v again where they overlap, (TR + 2h)(TC + 2h) / (TR TC) times.  On
// chip the pace is set by the instructions each point of each shrinking
// region takes (its shifted reads, its chain of multiply-adds, the
// recurrence's shared-memory traffic and the loop around them), and a
// tile's load and its p barriers wait on its slowest thread; the halo also
// recomputes the points near the tile's edge.
//
// Layout.  The host plans the tile (kernels/poly_apply.py::tile_plan): an
// interior of TR x TC grid points per block and a halo of h = s points on
// each side, s the number of sweeps that read a shifted vector (p for
// Chebyshev, p - 1 for Neumann).  Each offset is dr C + dc with |dr|,
// |dc| <= 1, so the shifted read of buffer point (i, j) is point
// (i + dr, j + dc).  A buffer point is the flat index (r0 + i) C + (c0 + j)
// of the grid, whatever its column: a halo column c < 0 or c >= C is a point
// of the neighbouring grid row, exactly as the flat shifts read it, so the
// left and right strips cancel those reads in the sum as they do in the flat
// kernel, and each point is computed with the arithmetic of its flat index.
// Points outside [0, n) are structural zeros (strips never come with wrap).
//
// Shared memory holds three buffers of (TR + 2h) x (TC + 2h) values and one
// of TR x TC.  Chebyshev: the ping-pong pair of d (the first holds
// x = v / theta, which the first sweep reads shifted), r, and x on the
// interior alone (only y = x + d needs it).  Neumann: the pair of z, D^-1,
// and acc on the interior.  Sweep k runs on the buffer shrunk by k + 1 on
// each side, so after the last sweep the interior is exact; a barrier
// separates the sweeps.  Only v (and D^-1, and the strips) are read from
// device memory and only y is written: there is no scratch, no atomic, and
// two launches on the same input are bit-equal.  The last tile of a row or
// column is ragged: its interior is cut at the grid's edge.  Index
// arithmetic on the grid is 64-bit; within a tile, 32-bit.
//
// In each sweep a thread walks down a run of rows of one column of the
// region and keeps the 3 x 3 window of the shifted vector in registers:
// three shared loads a point, no index arithmetic but an increment.  The
// product sums the nine cells of the box in row-major order, which is the
// ascending order of the offsets, with zero in the cells no offset lands in:
// a zero term adds exactly nothing, so each point gets the bits of the
// offsets' chain.  The points on the boundary strips read strip
// coefficients from device memory; they are set apart, one a thread, and
// take stencil_sum over the shared buffer as the flat kernel takes it, so
// that no run waits on those loads row after row.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stencil_row.cuh"

#define TILED_MAX_DEGREE 64
#define TILED_THREADS 256
#define TILED_MAX_DEVICES 64
// blocks resident on an SM: the registers are capped so that three fit
// (65,536 / (3 x 256) = 85 a thread)
#define TILED_BLOCKS_PER_SM 3
// a block's shared memory on sm_90, above 48 KB only by the opt-in attribute
#define TILED_MAX_SMEM 232448
// points a thread has in flight while the tile loads
#define TILED_LOADS 12

struct ChebCoef {
  double a[TILED_MAX_DEGREE];  // step k (1 <= k < p) at k - 1: rho' rho
  double b[TILED_MAX_DEGREE];  //                                2 rho' / delta
};

// The stencil on its grid, and the tile plan
template <typename T>
struct GridOp {
  StencilParams<T> p;  // p.off unread: the buffer is read through delta
  const T* top;
  const T* bot;
  const T* left;
  const T* right;
  long long n, C, R;
  int ndiag;
  int tile_r, tile_c;  // a full tile's interior
  int halo;            // the sweeps
  int stride;          // tile_c + 2 halo: a buffer row
  int delta[STENCIL_MAX_DIAGS];  // dr stride + dc of offset dr C + dc
  T box[9];  // the constants on the 3 x 3 box, (dr, dc) = (-1, -1) ... (1, 1)
};

// This block's tile: buffer point (i, j) is grid point (r0 + i, c0 + j)
struct Tile {
  long long r0, c0;
  int th, tw;      // the interior, cut at the grid's last row and column
  int rows, cols;  // the buffer in use: th + 2 halo by tw + 2 halo
};

template <typename T>
__device__ __forceinline__ Tile tile_of(const GridOp<T>& op) {
  const long long tiles_c = (op.C + op.tile_c - 1) / op.tile_c;
  const long long tr = blockIdx.x / tiles_c;
  const long long ir = tr * op.tile_r;
  const long long ic = (blockIdx.x - tr * tiles_c) * op.tile_c;
  Tile t;
  t.th = (int)min((long long)op.tile_r, op.R - ir);
  t.tw = (int)min((long long)op.tile_c, op.C - ic);
  t.r0 = ir - op.halo;
  t.c0 = ic - op.halo;
  t.rows = t.th + 2 * op.halo;
  t.cols = t.tw + 2 * op.halo;
  return t;
}

// The grid row and column of buffer point (i, j) after one wrap of the
// column (halo <= C), its flat index, and whether that lies in [0, n)
struct Point {
  long long f, r, c;
  bool valid;
};

template <typename T>
__device__ __forceinline__ Point point(const GridOp<T>& op, const Tile& t,
                                       int i, int j) {
  long long r = t.r0 + i, c = t.c0 + j;
  if (c < 0) {
    c += op.C;
    --r;
  } else if (c >= op.C) {
    c -= op.C;
    ++r;
  }
  return Point{r * op.C + c, r, c, r >= 0 && r < op.R};
}

// Load the tile's buffer: v (Chebyshev) or D^-1 (Neumann) into `keep`, x =
// v / theta or z = omega D^-1 v into b0, zeros into b1; 0 where the flat
// index leaves [0, n)
template <typename T, bool CHEB>
__device__ __forceinline__ void load_tile(const GridOp<T>& op, const Tile& t,
                                          const T* __restrict__ v,
                                          const T* __restrict__ dinv, T scal,
                                          T* b0, T* b1, T* keep) {
  const int count = t.rows * t.cols;
  for (int q0 = threadIdx.x; q0 < count; q0 += TILED_LOADS * TILED_THREADS) {
    T vi[TILED_LOADS], di[TILED_LOADS];
    int at[TILED_LOADS];
#pragma unroll
    for (int u = 0; u < TILED_LOADS; ++u) {
      const int q = q0 + u * TILED_THREADS;
      const int i = q / t.cols, j = q - i * t.cols;
      const Point pt = point(op, t, i, j);
      const bool ok = q < count && pt.valid;
      at[u] = q < count ? i * op.stride + j : -1;
      vi[u] = ok ? __ldg(v + pt.f) : T(0);
      di[u] = (!CHEB && ok) ? __ldg(dinv + pt.f) : T(0);
    }
#pragma unroll
    for (int u = 0; u < TILED_LOADS; ++u) {
      if (at[u] < 0) continue;
      // a structural zero loaded 0 for v and D^-1, and gives 0 here too
      if (CHEB) {
        keep[at[u]] = vi[u];
        b0[at[u]] = vi[u] / scal;
      } else {
        keep[at[u]] = di[u];
        b0[at[u]] = scal * (di[u] * vi[u]);
      }
      b1[at[u]] = T(0);
    }
  }
}

// One point's step of the recurrence, given its product and its own value
// `own` of the shifted vector (x or d; z): the flat kernel's arithmetic,
// with r (or D^-1) in keep and x (or acc) in xb on the interior.  In the
// last sweep the region is the interior and y is written.
template <typename T, bool CHEB>
__device__ __forceinline__ void step_point(T prod, T own, T* keep, T* dst,
                                           T* xb, T* __restrict__ y, int at,
                                           int xi_at, bool inner, long long f,
                                           bool first, bool last, T a, T b,
                                           T c0, T omega) {
  if (CHEB) {
    const T ri = keep[at] - prod;
    T xi = own, dn;
    if (first) {  // own is x = v / theta
      dn = c0 * ri;
    } else {  // own is d of the step before
      if (inner) xi = xb[xi_at] + own;
      dn = a * own + b * ri;
    }
    if (last) {
      y[f] = xi + dn;
    } else {
      if (inner) xb[xi_at] = xi;
      keep[at] = ri;
      dst[at] = dn;
    }
  } else {  // own is z of this step
    const T zn = own - omega * (keep[at] * prod);
    if (last) {
      y[f] = (first ? own : xb[xi_at]) + zn;
    } else {
      if (inner) xb[xi_at] = (first ? own : xb[xi_at]) + zn;
      dst[at] = zn;
    }
  }
}

// the nine-cell product of rows u (above), m and d (below) of the window
template <typename T>
__device__ __forceinline__ T box_product(const GridOp<T>& op,
                                         const T (&u)[3], const T (&m)[3],
                                         const T (&d)[3]) {
  T prod = T(0);
  prod += op.box[0] * u[0];
  prod += op.box[1] * u[1];
  prod += op.box[2] * u[2];
  prod += op.box[3] * m[0];
  prod += op.box[4] * m[1];
  prod += op.box[5] * m[2];
  prod += op.box[6] * d[0];
  prod += op.box[7] * d[1];
  prod += op.box[8] * d[2];
  return prod;
}

template <typename T, bool CHEB>
__global__ void __launch_bounds__(TILED_THREADS, TILED_BLOCKS_PER_SM)
    tiled_kernel(const __grid_constant__ GridOp<T> op,
                 const T* __restrict__ v, const T* __restrict__ dinv,
                 T* __restrict__ y, int sweeps, T scal, T c0,
                 const __grid_constant__ ChebCoef cf) {
  // scal: theta (Chebyshev) or omega (Neumann); c0 and cf: Chebyshev only.
  // Buffers: b0, b1 (d or z), keep (Chebyshev: v, then r; Neumann: D^-1)
  // and, on the interior, xb (x or acc).
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = op.stride;
  const int plane = (op.tile_r + 2 * op.halo) * S;
  T* b0 = reinterpret_cast<T*>(smem);
  T* b1 = b0 + plane;
  T* keep = b1 + plane;
  T* xb = keep + plane;
  const Tile t = tile_of(op);
  load_tile<T, CHEB>(op, t, v, dinv, scal, b0, b1, keep);
  if (!CHEB && sweeps == 0) {  // Neumann of degree 1: y = omega D^-1 v
    __syncthreads();
    for (int q = threadIdx.x; q < t.rows * t.cols; q += TILED_THREADS) {
      const int i = q / t.cols, j = q - i * t.cols;
      y[point(op, t, i, j).f] = b0[i * S + j];
    }
    return;
  }
  // the buffer's columns on grid columns 0 and C - 1, every C columns from
  // the first of each, and whether the buffer meets grid row 0 or R - 1
  long long jl = -t.c0 % op.C, jr = (op.C - 1 - t.c0) % op.C;
  if (jl < 0) jl += op.C;
  if (jr < 0) jr += op.C;
  const int n_left = jl < t.cols ? (int)((t.cols - 1 - jl) / op.C) + 1 : 0;
  const int n_edge =
      n_left + (jr < t.cols ? (int)((t.cols - 1 - jr) / op.C) + 1 : 0);
  const bool edge_rows = t.r0 <= 1 || t.r0 + t.rows >= op.R - 1;
  for (int k = 0; k < sweeps; ++k) {
    __syncthreads();
    const T* src = (k & 1) ? b1 : b0;
    T* dst = (k & 1) ? b0 : b1;
    const T a = (CHEB && k) ? (T)cf.a[k - 1] : T(0);
    const T b = (CHEB && k) ? (T)cf.b[k - 1] : T(0);
    const bool first = k == 0, last = k == sweeps - 1;
    // the region, the buffer shrunk by k + 1 a side, cut into runs of rows
    // of a column: as many runs a column as the threads allow
    const int lo = k + 1, w = t.cols - 2 * lo, h = t.rows - 2 * lo;
    const int runs = max(1, TILED_THREADS / w);
    const int run = (h + runs - 1) / runs;
    for (int item = threadIdx.x; item < w * runs; item += TILED_THREADS) {
      const int j = lo + item % w;
      const int i_begin = lo + (item / w) * run;
      const int i_end = min(i_begin + run, lo + h);
      if (i_begin >= i_end) continue;
      const Point p0 = point(op, t, i_begin, j);
      if (p0.c == 0 || p0.c == op.C - 1) continue;  // an edge column
      const bool inner_col = j >= op.halo && j < op.halo + t.tw;
      int i = i_begin, at = i * S + j;
      int xi_at = (i - op.halo) * op.tile_c + (j - op.halo);
      long long f = p0.f;
      // the window: rows i - 1 and i now, row i + 1 loaded by each step
      T w0[3], w1[3], w2[3];
      const T* p = src + at - S;
      w0[0] = p[-1];
      w0[1] = p[0];
      w0[2] = p[1];
      p += S;
      w1[0] = p[-1];
      w1[1] = p[0];
      w1[2] = p[1];
      p += S;
      const auto inner = [&]() {
        return inner_col && i >= op.halo && i < op.halo + t.th;
      };
      if (p0.r > 0 && p0.r + (i_end - i_begin) < op.R) {
        // every point of the run is off the strips and in the grid: the
        // window's rows take turns by name, three steps a turn
        const auto step = [&](const T(&u)[3], const T(&m)[3], T(&d)[3]) {
          d[0] = p[-1];
          d[1] = p[0];
          d[2] = p[1];
          step_point<T, CHEB>(box_product(op, u, m, d), m[1], keep, dst, xb,
                              y, at, xi_at, inner(), f, first, last, a, b, c0,
                              scal);
          p += S;
          at += S;
          xi_at += op.tile_c;
          f += op.C;
          ++i;
        };
        for (; i + 3 <= i_end;) {
          step(w0, w1, w2);
          step(w1, w2, w0);
          step(w2, w0, w1);
        }
        if (i < i_end) step(w0, w1, w2);
        if (i < i_end) step(w1, w2, w0);
        continue;
      }
      // a run that meets the top or bottom strip, or leaves the grid: one
      // step a row, the window shifted by value, those rows skipped
      for (long long gr = p0.r; i < i_end; ++i, ++gr) {
        w2[0] = p[-1];
        w2[1] = p[0];
        w2[2] = p[1];
        if (gr > 0 && gr < op.R - 1)
          step_point<T, CHEB>(box_product(op, w0, w1, w2), w1[1], keep, dst,
                              xb, y, at, xi_at, inner(), f, first, last, a, b,
                              c0, scal);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          w0[c] = w1[c];
          w1[c] = w2[c];
        }
        p += S;
        at += S;
        xi_at += op.tile_c;
        f += op.C;
      }
    }
    // the strip points of the region, one a thread: the rows of grid rows 0
    // and R - 1 in each column that is not an edge, then every row of the
    // edge columns
    const int top_bot = edge_rows ? 2 * w : 0;
    for (int q = threadIdx.x; q < top_bot + n_edge * h; q += TILED_THREADS) {
      int i, j;
      if (q < top_bot) {
        j = lo + q / 2;
        const Point pj = point(op, t, lo, j);
        if (pj.c == 0 || pj.c == op.C - 1) continue;
        const long long di = ((q & 1) ? op.R - 1 : 0) - pj.r;
        if (di < 0 || di >= h) continue;
        i = lo + (int)di;
      } else {
        const int e = (q - top_bot) / h;
        i = lo + (q - top_bot) - e * h;
        j = (int)(e < n_left ? jl + e * op.C : jr + (e - n_left) * op.C);
        if (j < lo || j >= lo + w) continue;
      }
      const Point q0 = point(op, t, i, j);
      if (!q0.valid) continue;
      const int at = i * S + j;
      const auto xv = [&](int d) { return src[at + op.delta[d]]; };
      const T prod = stencil_sum<T>(xv, q0.f, q0.r, q0.c, op.n, op.ndiag,
                                    op.p, op.C, op.R, op.top, op.bot, op.left,
                                    op.right);
      const bool inner = j >= op.halo && j < op.halo + t.tw &&
                         i >= op.halo && i < op.halo + t.th;
      step_point<T, CHEB>(prod, src[at], keep, dst, xb, y, at,
                          (i - op.halo) * op.tile_c + (j - op.halo), inner,
                          q0.f, first, last, a, b, c0, scal);
    }
  }
}

// The operator and plan as the C interface gives them, checked: a grid of
// R >= 3 rows of C >= 2 columns, strips, offsets in ascending order, each
// dr C + dc with |dr|, |dc| <= 1 (|dc| <= C / 2 picks the split), and a
// halo (the sweeps) of at most a grid row.  plan: tile_r, tile_c.
template <typename T>
static int grid_op(GridOp<T>* op, long long n, int ndiag,
                   const long long* offsets, const double* consts,
                   long long grid_c, const void* top, const void* bot,
                   const void* left, const void* right, const int* plan,
                   int sweeps, size_t* smem) {
  const int tile_r = plan[0], tile_c = plan[1];
  if (ndiag < 1 || ndiag > 9 || grid_c < 2 || n < 1 || n % grid_c != 0 ||
      n / grid_c < 3 || !top || !bot || !left || !right || tile_r < 1 ||
      tile_c < 1 || sweeps < 0 || sweeps > grid_c)
    return (int)cudaErrorInvalidValue;
  op->n = n;
  op->C = grid_c;
  op->R = n / grid_c;
  op->ndiag = ndiag;
  op->tile_r = tile_r;
  op->tile_c = tile_c;
  op->halo = sweeps;
  op->stride = tile_c + 2 * sweeps;
  for (int d = 0; d < STENCIL_MAX_DIAGS; ++d) {
    op->p.off[d] = d < ndiag ? offsets[d] : 0;
    op->p.c[d] = d < ndiag ? (T)consts[d] : T(0);
    op->delta[d] = 0;
  }
  for (int k = 0; k < 9; ++k) op->box[k] = T(0);
  for (int d = 0; d < ndiag; ++d) {
    const long long half = grid_c / 2;
    long long dr = (offsets[d] + half) / grid_c;
    if ((offsets[d] + half) % grid_c < 0) --dr;  // floor
    const long long dc = offsets[d] - dr * grid_c;
    if (dr < -1 || dr > 1 || dc < -1 || dc > 1 ||
        (d > 0 && offsets[d] <= offsets[d - 1]))
      return (int)cudaErrorInvalidValue;  // the box sums in this order
    op->delta[d] = (int)(dr * op->stride + dc);
    op->box[(dr + 1) * 3 + (dc + 1)] = (T)consts[d];
  }
  op->top = (const T*)top;
  op->bot = (const T*)bot;
  op->left = (const T*)left;
  op->right = (const T*)right;
  *smem = (3 * ((size_t)tile_r + 2 * sweeps) * op->stride +
           (size_t)tile_r * tile_c) * sizeof(T);
  if (*smem > TILED_MAX_SMEM) return (int)cudaErrorInvalidValue;
  return 0;
}

// One launch of tiled_kernel: a block per tile.  The opt-in shared-memory
// attribute belongs to the kernel; it is set once per kernel and device, to
// the most a block may have, so no plan asks above it.
template <typename T, bool CHEB>
static int launch(const GridOp<T>& op, size_t smem, int device, void* stream,
                  const T* v, const T* dinv, T* y, int sweeps, T scal, T c0,
                  const ChebCoef& cf) {
  static bool allowed[TILED_MAX_DEVICES];
  if (device < 0 || device >= TILED_MAX_DEVICES)
    return (int)cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!allowed[device]) {
    err = cudaFuncSetAttribute((const void*)tiled_kernel<T, CHEB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               TILED_MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
    allowed[device] = true;
  }
  const long long tiles = ((op.R + op.tile_r - 1) / op.tile_r) *
                          ((op.C + op.tile_c - 1) / op.tile_c);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  tiled_kernel<T, CHEB><<<(unsigned)tiles, TILED_THREADS, smem,
                          (cudaStream_t)stream>>>(op, v, dinv, y, sweeps, scal,
                                                  c0, cf);
  return (int)cudaGetLastError();
}

template <typename T>
static int cheb(long long n, int ndiag, const long long* offsets,
                const double* consts, long long grid_c, const void* top,
                const void* bot, const void* left, const void* right,
                const int* plan, const void* v, void* y, int degree,
                double theta, double c0, const double* coef_a,
                const double* coef_b, int device, void* stream) {
  if (degree < 1 || degree > TILED_MAX_DEGREE)
    return (int)cudaErrorInvalidValue;
  GridOp<T> op;
  size_t smem = 0;
  int bad = grid_op<T>(&op, n, ndiag, offsets, consts, grid_c, top, bot, left,
                       right, plan, degree, &smem);
  if (bad) return bad;
  ChebCoef cf;
  for (int k = 0; k < TILED_MAX_DEGREE; ++k) {
    cf.a[k] = k < degree - 1 ? coef_a[k] : 0.0;
    cf.b[k] = k < degree - 1 ? coef_b[k] : 0.0;
  }
  return launch<T, true>(op, smem, device, stream, (const T*)v, nullptr,
                         (T*)y, degree, (T)theta, (T)c0, cf);
}

template <typename T>
static int neumann(long long n, int ndiag, const long long* offsets,
                   const double* consts, long long grid_c, const void* top,
                   const void* bot, const void* left, const void* right,
                   const int* plan, const void* v, const void* dinv, void* y,
                   int degree, double omega, int device, void* stream) {
  if (degree < 1 || degree > TILED_MAX_DEGREE)
    return (int)cudaErrorInvalidValue;
  GridOp<T> op;
  size_t smem = 0;
  int bad = grid_op<T>(&op, n, ndiag, offsets, consts, grid_c, top, bot, left,
                       right, plan, degree - 1, &smem);
  if (bad) return bad;
  const ChebCoef unused = {};
  return launch<T, false>(op, smem, device, stream, (const T*)v,
                          (const T*)dinv, (T*)y, degree - 1, (T)omega, T(0),
                          unused);
}

extern "C" {

// n, ndiag, offsets, consts, grid_c and the strips (top, bot: (ndiag, C);
// left, right: (ndiag, R)) as in stencil_row.cuh; plan: tile_r, tile_c
// (grid_op); v, y: (n,); coef_a, coef_b: degree - 1 values each.  Returns
// a cudaError code.
#define TILED_OP_PARAMS                                                 \
  long long n, int ndiag, const long long *offsets,                    \
      const double *consts, long long grid_c, const void *top,         \
      const void *bot, const void *left, const void *right,            \
      const int *plan
#define TILED_OP_ARGS \
  n, ndiag, offsets, consts, grid_c, top, bot, left, right, plan

int cheb_tiled_f64(TILED_OP_PARAMS, const void* v, void* y, int degree,
                   double theta, double c0, const double* coef_a,
                   const double* coef_b, int device, void* stream) {
  return cheb<double>(TILED_OP_ARGS, v, y, degree, theta, c0, coef_a, coef_b,
                      device, stream);
}

int cheb_tiled_f32(TILED_OP_PARAMS, const void* v, void* y, int degree,
                   double theta, double c0, const double* coef_a,
                   const double* coef_b, int device, void* stream) {
  return cheb<float>(TILED_OP_ARGS, v, y, degree, theta, c0, coef_a, coef_b,
                     device, stream);
}

// dinv: (n,)
int neumann_tiled_f64(TILED_OP_PARAMS, const void* v, const void* dinv,
                      void* y, int degree, double omega, int device,
                      void* stream) {
  return neumann<double>(TILED_OP_ARGS, v, dinv, y, degree, omega, device,
                         stream);
}

int neumann_tiled_f32(TILED_OP_PARAMS, const void* v, const void* dinv,
                      void* y, int degree, double omega, int device,
                      void* stream) {
  return neumann<float>(TILED_OP_ARGS, v, dinv, y, degree, omega, device,
                        stream);
}

}  // extern "C"

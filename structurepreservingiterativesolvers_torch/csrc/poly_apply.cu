// Fused polynomial preconditioner applies for Hopper (sm_90a), f64 and f32:
// the degree-p Chebyshev and truncated Neumann recurrences, p(A) v, in one
// launch each.
//
// Chebyshev, given theta, delta and sigma = theta / delta, with rho = 1/sigma:
//
//   x = v / theta,  r = v - A x,  d = (2 rho / delta) r
//   p - 1 times:  x += d,  r -= A d,  rho' = 1 / (2 sigma - rho),
//                 d = (rho' rho) d + (2 rho' / delta) r,  rho = rho'
//   y = x + d
//
// Neumann, with D the diagonal of A:
//
//   z = omega D^-1 v,  acc = z
//   p - 1 times:  z -= omega D^-1 (A z),  acc += z
//   y = acc
//
// in the order and with the roundings of the JAX package's unfused
// recurrences (precond/chebyshev.py: Chebyshev.__call__, Neumann.__call__).
// The scalars depend only on sigma and delta, so the host computes them and
// passes them by value: c0 = 2 rho / delta, and a_k = rho' rho and
// b_k = 2 rho' / delta for step k.  A is either form the port has:
//
//   DIA      y[i] = sum_d data[d, i] * x[i + off_d], wrapped or zero-filled
//   stencil  constants plus boundary strips (stencil_row.cuh)
//
// Replaces the TPU kernels ops/pallas_poly.py::cheb_apply_fused and
// ::neumann_apply_fused of the JAX package.  Those time-tile the recurrence:
// each program loads a window of R + 2 p span rows of x and of the
// pre-gathered DIA data into VMEM and runs all p steps there, in a
// (rows, 128)-lane layout with roll-based shifts.  None of that is carried
// over: the windows, the rolls and the VMEM fit serve Mosaic, and a flat
// halo at heat's span (1026) and p = 8 is 16 K rows a side, more than an
// SM's shared memory holds for three f64 vectors.  The stencil form reads
// the constants and strips, never the materialised DIA data.
//
// What bounds it: bytes, but not the bytes of the ideal.  The ideal reads v
// once (and D^-1 for Neumann, and the strips), and writes y once: 17 MB at
// heat M=1024 in f64.  This design runs p dependent sweeps over the whole
// vector, each reading d (or z) at every shift and reading and writing the
// recurrence vectors x, r, d (or acc, z): about 5 n values a sweep, 8.4 MB
// each at n = 1,050,625, most of it served by the 50 MB L2.
//
// What the design does about the launch count: one cooperative launch per
// apply.  A persistent grid, as many blocks as fit on the card at once
// (occupancy x SMs), strides over the rows; a grid-wide barrier separates
// the sweeps, so a sweep reads the previous step's d (or z) only after every
// thread has written it.  d and z are ping-ponged between two buffers, so no
// sweep reads what it is writing; x, r and acc are read and written only by
// the thread that owns the row.  The first sweep reads v through a loader
// that applies v / theta (or omega D^-1 v) on the fly, so x (or z) need not
// be stored and re-read behind a barrier first, and the last sweep writes
// y.  So Chebyshev runs p sweeps and p - 1 barriers, Neumann p - 1 sweeps
// and p - 2 barriers.  Vectors written inside the launch are read with
// plain coherent loads, never through the read-only path.  Index arithmetic
// is 64-bit.  Time tiling in shared memory (a 2-D tile at heat's span) is
// poly_tiled.cu's design.
//
// The block forms (#3b, #4b): one cooperative launch applies the polynomial
// to nvec vectors, the rows of a (B, n) block read through its (n, B) view,
// v's rows ldv apart and y's ldy apart, as pallas_call's batching rule gives
// the Pallas kernels under jax.vmap a grid axis over the batch, and 4 n
// (3 n) values of scratch a vector.  Where the resident blocks serve every
// vector at once, each taking the blocks its rows fill (small n), the
// grid's y axis is over the vectors.  Otherwise (heat M=1024: one vector's
// rows fill the card) the launch walks the block in rounds of as many
// vectors as they serve at once, one at heat M=1024, so each vector takes
// every resident block and the sweeps' working set stays a single apply's
// (v, y and the recurrence vectors, about 50 MB there in f64) rather than
// B times it.  Both kernels run one body, the first without the walk, so
// one vector runs the single apply's code.  Each row takes the arithmetic
// of one apply, so each column takes kernel #3's (or #4's) bits on that
// vector; D^-1 is shared.  Every load and store is of one T, so a row may
// start at any element offset.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "stencil_row.cuh"

namespace cg = cooperative_groups;

#define POLY_MAX_DIAGS 64
#define POLY_MAX_DEGREE 64
#define POLY_THREADS 256
#define POLY_MAX_DEVICES 64
// vectors of one launch: the grid's y axis
#define POLY_MAX_VECTORS 65535
// blocks an SM keeps resident in the rounds, the kernels' register bound.
// At heat's stencil in f64 the single applies take 64 registers a thread,
// 4 blocks; the walk's loop takes 80 for Chebyshev (3 blocks) and 64 for
// Neumann.  Bounding Chebyshev to 64 spills and ran 4-6% slower than at 3
// blocks; Neumann keeps 4 (PERF.md section 6)
#define POLY_CHEB_ROUNDS_MIN_BLOCKS 3
#define POLY_NEUMANN_ROUNDS_MIN_BLOCKS 4

// v / theta, applied where it is read
template <typename T>
struct DivLoad {
  const T* v;
  T theta;
  __device__ __forceinline__ T operator()(long long j) const {
    return __ldg(v + j) / theta;
  }
};

// omega * (D^-1 v), applied where it is read
template <typename T>
struct JacobiLoad {
  const T* v;
  const T* dinv;
  T omega;
  __device__ __forceinline__ T operator()(long long j) const {
    return omega * (__ldg(dinv + j) * __ldg(v + j));
  }
};

template <typename T, bool WRAP>
struct DiaOp {
  long long off[POLY_MAX_DIAGS];
  const T* data;  // (ndiag, n), row-aligned
  long long n;
  int ndiag;

  template <class L>
  __device__ __forceinline__ T row(const L& ld, long long i) const {
    T acc = T(0);
    for (int d = 0; d < ndiag; ++d) {
      acc += __ldg(data + (long long)d * n + i) *
             shifted<T, WRAP>(ld, i + off[d], n);
    }
    return acc;
  }
};

template <typename T, bool WRAP>
struct StencilOp {
  StencilParams<T> p;
  const T* top;
  const T* bot;
  const T* left;
  const T* right;
  long long n, C, R;
  int ndiag;

  template <class L>
  __device__ __forceinline__ T row(const L& ld, long long i) const {
    return stencil_row<T, WRAP>(ld, i, n, ndiag, p, C, R, top, bot, left,
                                right);
  }
};

struct ChebCoef {
  double a[POLY_MAX_DEGREE];  // step k (1 <= k < p) at k - 1: rho' rho
  double b[POLY_MAX_DEGREE];  //                                2 rho' / delta
};

// The k-th of the `count` n-value vectors of scratch of vector j; null
// where there is no scratch
template <typename T>
__device__ __forceinline__ T* scratch_of(T* scratch, long long n, int count,
                                         int j, int k) {
  return scratch ? scratch + ((long long)j * count + k) * n : nullptr;
}

// The vector of this block in round `round`: j, and the rows it strides
// over, none past the last vector.  Without ROUNDS the grid's y axis holds
// every vector and there is one round.
template <bool ROUNDS>
__device__ __forceinline__ int vector_of(int round, int nvec, long long n,
                                         long long* rows) {
  const int j = ROUNDS ? round * (int)gridDim.y + (int)blockIdx.y
                       : (int)blockIdx.y;
  *rows = (!ROUNDS || j < nvec) ? n : 0;
  return (!ROUNDS || j < nvec) ? j : 0;
}

// The Chebyshev apply of the launch: the kernels below without and with
// the walk
template <typename T, class Op, bool ROUNDS>
__device__ __forceinline__ void cheb_vectors(
    const Op& op, const T* __restrict__ v0, T* y0, T* scratch, int nvec,
    long long ldv, long long ldy, int degree, T theta, T c0,
    const ChebCoef& cf) {
  cg::grid_group grid = cg::this_grid();
  const long long n = op.n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int nround = ROUNDS ? (nvec + (int)gridDim.y - 1) / (int)gridDim.y : 1;
  // a round needs no barrier before it: its vectors' scratch is their own.
  // A block past the last vector strides over no rows but keeps the
  // barriers.
  for (int round = 0; round < nround; ++round) {
    long long rows;
    const int j = vector_of<ROUNDS>(round, nvec, n, &rows);
    // its v, y, and x, r, d0, d1 (unread at degree 1)
    const T* v = v0 + (long long)j * ldv;
    T* y = y0 + (long long)j * ldy;
    T* x = scratch_of(scratch, n, 4, j, 0);
    T* r = scratch_of(scratch, n, 4, j, 1);
    T* d0 = scratch_of(scratch, n, 4, j, 2);
    T* d1 = scratch_of(scratch, n, 4, j, 3);
    {
      const DivLoad<T> ld{v, theta};
      for (long long i = first; i < rows; i += stride) {
        const T vi = __ldg(v + i);
        const T xi = vi / theta;
        const T ri = vi - op.row(ld, i);
        const T di = c0 * ri;
        if (degree == 1) {
          y[i] = xi + di;
        } else {
          x[i] = xi;
          r[i] = ri;
          d0[i] = di;
        }
      }
    }
    for (int k = 1; k < degree; ++k) {
      grid.sync();
      const T* dc = (k & 1) ? d0 : d1;  // d of step k - 1
      T* dn = (k & 1) ? d1 : d0;
      const T a = (T)cf.a[k - 1];
      const T b = (T)cf.b[k - 1];
      const CoherentLoad<T> ld{dc};
      for (long long i = first; i < rows; i += stride) {
        const T di = dc[i];
        const T xi = x[i] + di;
        const T ri = r[i] - op.row(ld, i);
        const T dni = a * di + b * ri;
        if (k == degree - 1) {
          y[i] = xi + dni;
        } else {
          x[i] = xi;
          r[i] = ri;
          dn[i] = dni;
        }
      }
    }
  }
}

// The Neumann apply of the launch, as cheb_vectors
template <typename T, class Op, bool ROUNDS>
__device__ __forceinline__ void neumann_vectors(
    const Op& op, const T* __restrict__ v0, const T* __restrict__ dinv,
    T* y0, T* scratch, int nvec, long long ldv, long long ldy, int degree,
    T omega) {
  cg::grid_group grid = cg::this_grid();
  const long long n = op.n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int nround = ROUNDS ? (nvec + (int)gridDim.y - 1) / (int)gridDim.y : 1;
  // the rounds, as in cheb_kernel; D^-1 is shared
  for (int round = 0; round < nround; ++round) {
    long long rows;
    const int j = vector_of<ROUNDS>(round, nvec, n, &rows);
    // its v, y, and acc, z0, z1 (unread below degree 3)
    const T* v = v0 + (long long)j * ldv;
    T* y = y0 + (long long)j * ldy;
    T* acc = scratch_of(scratch, n, 3, j, 0);
    T* z0 = scratch_of(scratch, n, 3, j, 1);
    T* z1 = scratch_of(scratch, n, 3, j, 2);
    if (degree == 1) {  // no barrier at degree 1
      for (long long i = first; i < rows; i += stride) {
        y[i] = omega * (__ldg(dinv + i) * __ldg(v + i));
      }
      continue;
    }
    {
      const JacobiLoad<T> ld{v, dinv, omega};
      for (long long i = first; i < rows; i += stride) {
        const T di = __ldg(dinv + i);
        const T zi = omega * (di * __ldg(v + i));
        const T zni = zi - omega * (di * op.row(ld, i));
        const T ai = zi + zni;
        if (degree == 2) {
          y[i] = ai;
        } else {
          acc[i] = ai;
          z0[i] = zni;
        }
      }
    }
    for (int k = 2; k < degree; ++k) {
      grid.sync();
      const T* zc = (k & 1) ? z1 : z0;  // z of step k - 1
      T* zn = (k & 1) ? z0 : z1;
      const CoherentLoad<T> ld{zc};
      for (long long i = first; i < rows; i += stride) {
        const T zni = zc[i] - omega * (__ldg(dinv + i) * op.row(ld, i));
        const T ai = acc[i] + zni;
        if (k == degree - 1) {
          y[i] = ai;
        } else {
          acc[i] = ai;
          zn[i] = zni;
        }
      }
    }
  }
}

// The kernels: every vector at once (one apply: the single kernel), and
// the walk in rounds, its registers bounded (POLY_*_ROUNDS_MIN_BLOCKS)
template <typename T, class Op>
__global__ void cheb_kernel(Op op, const T* __restrict__ v0, T* y0,
                            T* scratch, int nvec, long long ldv,
                            long long ldy, int degree, T theta, T c0,
                            ChebCoef cf) {
  cheb_vectors<T, Op, false>(op, v0, y0, scratch, nvec, ldv, ldy, degree,
                             theta, c0, cf);
}

template <typename T, class Op>
__global__ void __launch_bounds__(POLY_THREADS, POLY_CHEB_ROUNDS_MIN_BLOCKS)
    cheb_rounds_kernel(Op op, const T* __restrict__ v0, T* y0, T* scratch,
                       int nvec, long long ldv, long long ldy, int degree,
                       T theta, T c0, ChebCoef cf) {
  cheb_vectors<T, Op, true>(op, v0, y0, scratch, nvec, ldv, ldy, degree,
                            theta, c0, cf);
}

template <typename T, class Op>
__global__ void neumann_kernel(Op op, const T* __restrict__ v0,
                               const T* __restrict__ dinv, T* y0, T* scratch,
                               int nvec, long long ldv, long long ldy,
                               int degree, T omega) {
  neumann_vectors<T, Op, false>(op, v0, dinv, y0, scratch, nvec, ldv, ldy,
                                degree, omega);
}

template <typename T, class Op>
__global__ void __launch_bounds__(POLY_THREADS,
                                  POLY_NEUMANN_ROUNDS_MIN_BLOCKS)
    neumann_rounds_kernel(Op op, const T* __restrict__ v0,
                          const T* __restrict__ dinv, T* y0, T* scratch,
                          int nvec, long long ldv, long long ldy, int degree,
                          T omega) {
  neumann_vectors<T, Op, true>(op, v0, dinv, y0, scratch, nvec, ldv, ldy,
                               degree, omega);
}

// The blocks of `kernel` that can be resident at once on `device`, which a
// grid-wide barrier needs; asked once per kernel and device.  `rounds`
// tells apart the two kernels of one type.  0 on an error, which *err
// holds.
template <typename K>
static long long resident_blocks(K kernel, bool rounds, int device,
                                 int* err) {
  static int per_sm_of[2][POLY_MAX_DEVICES];  // 0: not asked yet
  static int sms_of[2][POLY_MAX_DEVICES];
  int* per_sm = per_sm_of[rounds];
  int* sms = sms_of[rounds];
  *err = 0;
  if (device < 0 || device >= POLY_MAX_DEVICES) {
    *err = (int)cudaErrorInvalidDevice;
    return 0;
  }
  if (per_sm[device] == 0) {
    int count = 0, nsm = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &count, kernel, POLY_THREADS, 0);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) {
      *err = (int)e;
      return 0;
    }
    if (count < 1) {
      *err = (int)cudaErrorCooperativeLaunchTooLarge;
      return 0;
    }
    sms[device] = nsm;
    per_sm[device] = count;
  }
  return (long long)per_sm[device] * sms[device];
}

// A cooperative launch over nvec vectors of n rows: on the x axis the
// blocks one vector's rows fill, at most every resident block; on the y
// axis every vector where the resident blocks serve them all at once
// (`at_once`), else as many as they serve, which `rounds` walks the block
// in.  The two kernels take the same arguments.
template <typename K>
static int coop_launch(K at_once, K rounds, void** args, long long n,
                       int nvec, int device, cudaStream_t s) {
  int err = 0;
  K kernel = at_once;
  long long resident = resident_blocks(at_once, false, device, &err);
  if (err) return err;
  const long long need = (n + POLY_THREADS - 1) / POLY_THREADS;
  long long blocks = need < resident ? need : resident;
  long long group = nvec;
  if (resident / blocks < nvec) {
    kernel = rounds;
    resident = resident_blocks(rounds, true, device, &err);
    if (err) return err;
    blocks = need < resident ? need : resident;
    group = resident / blocks < nvec ? resident / blocks : nvec;
  }
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)kernel, dim3((unsigned)blocks, (unsigned)group),
      dim3(POLY_THREADS), args, 0, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The operator as the C interface gives it: `data` non-null selects the DIA
// form, null the stencil form (consts, grid_c and the strips).
struct OpArgs {
  long long n;
  int ndiag;
  const long long* offsets;
  int wrap;
  const void* data;
  const double* consts;
  long long grid_c;
  const void* top;
  const void* bot;
  const void* left;
  const void* right;
};

// The vectors: nvec rows of n values, v's ldv apart and y's ldy apart
struct Rows {
  int nvec;
  long long ldv, ldy;
};

static int check_rows(const Rows& r, long long n) {
  if (r.nvec < 1 || r.nvec > POLY_MAX_VECTORS ||
      (r.nvec > 1 && (r.ldv < n || r.ldy < n)))
    return (int)cudaErrorInvalidValue;
  return 0;
}

static int check_op(const OpArgs& o) {
  if (o.ndiag < 0 || o.ndiag > POLY_MAX_DIAGS || o.n < 1)
    return (int)cudaErrorInvalidValue;
  if (o.data == nullptr &&
      (o.grid_c < 0 || (o.grid_c > 0 && (o.wrap || o.n % o.grid_c != 0))))
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename T, bool WRAP>
static DiaOp<T, WRAP> dia_op(const OpArgs& o) {
  DiaOp<T, WRAP> op;
  for (int d = 0; d < POLY_MAX_DIAGS; ++d)
    op.off[d] = d < o.ndiag ? o.offsets[d] : 0;
  op.data = (const T*)o.data;
  op.n = o.n;
  op.ndiag = o.ndiag;
  return op;
}

template <typename T, bool WRAP>
static StencilOp<T, WRAP> stencil_op(const OpArgs& o) {
  StencilOp<T, WRAP> op;
  for (int d = 0; d < STENCIL_MAX_DIAGS; ++d) {
    op.p.off[d] = d < o.ndiag ? o.offsets[d] : 0;
    op.p.c[d] = d < o.ndiag ? (T)o.consts[d] : T(0);
  }
  op.top = (const T*)o.top;
  op.bot = (const T*)o.bot;
  op.left = (const T*)o.left;
  op.right = (const T*)o.right;
  op.n = o.n;
  op.C = o.grid_c;
  op.R = o.grid_c > 0 ? o.n / o.grid_c : 0;
  op.ndiag = o.ndiag;
  return op;
}

template <typename T, class Op>
static int cheb_with(Op op, const void* v, void* y, void* scratch,
                     const Rows& rows, int degree, double theta, double c0,
                     const ChebCoef& cf, int device, cudaStream_t s) {
  const T* vp = (const T*)v;
  T* yp = (T*)y;
  T* base = (T*)scratch;  // 4 n values a vector (unused at degree 1)
  long long ldv = rows.ldv, ldy = rows.ldy;
  T th = (T)theta, c = (T)c0;
  ChebCoef coef = cf;
  int nvec = rows.nvec;
  void* args[] = {&op,  &vp,     &yp, &base, &nvec, &ldv,
                  &ldy, &degree, &th, &c,    &coef};
  return coop_launch(cheb_kernel<T, Op>, cheb_rounds_kernel<T, Op>, args, op.n,
                     rows.nvec, device, s);
}

template <typename T, class Op>
static int neumann_with(Op op, const void* v, const void* dinv, void* y,
                        void* scratch, const Rows& rows, int degree,
                        double omega, int device, cudaStream_t s) {
  const T* vp = (const T*)v;
  const T* dp = (const T*)dinv;
  T* yp = (T*)y;
  T* base = (T*)scratch;  // 3 n values a vector (unused below degree 3)
  long long ldv = rows.ldv, ldy = rows.ldy;
  T om = (T)omega;
  int nvec = rows.nvec;
  void* args[] = {&op, &vp, &dp, &yp, &base, &nvec, &ldv, &ldy, &degree, &om};
  return coop_launch(neumann_kernel<T, Op>, neumann_rounds_kernel<T, Op>, args,
                     op.n, rows.nvec, device, s);
}

template <typename T>
static int cheb(const OpArgs& o, const void* v, void* y, void* scratch,
                const Rows& rows, int degree, double theta, double c0,
                const double* coef_a, const double* coef_b, int device,
                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int bad = check_op(o);
  if (!bad) bad = check_rows(rows, o.n);
  if (bad) return bad;
  if (degree < 1 || degree > POLY_MAX_DEGREE || (degree > 1 && !scratch))
    return (int)cudaErrorInvalidValue;
  ChebCoef cf;
  for (int k = 0; k < POLY_MAX_DEGREE; ++k) {
    cf.a[k] = k < degree - 1 ? coef_a[k] : 0.0;
    cf.b[k] = k < degree - 1 ? coef_b[k] : 0.0;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (o.data) {
    if (o.wrap)
      return cheb_with<T>(dia_op<T, true>(o), v, y, scratch, rows, degree,
                          theta, c0, cf, device, s);
    return cheb_with<T>(dia_op<T, false>(o), v, y, scratch, rows, degree,
                        theta, c0, cf, device, s);
  }
  if (o.wrap)
    return cheb_with<T>(stencil_op<T, true>(o), v, y, scratch, rows, degree,
                        theta, c0, cf, device, s);
  return cheb_with<T>(stencil_op<T, false>(o), v, y, scratch, rows, degree,
                      theta, c0, cf, device, s);
}

template <typename T>
static int neumann(const OpArgs& o, const void* v, const void* dinv, void* y,
                   void* scratch, const Rows& rows, int degree, double omega,
                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int bad = check_op(o);
  if (!bad) bad = check_rows(rows, o.n);
  if (bad) return bad;
  if (degree < 1 || degree > POLY_MAX_DEGREE || (degree > 2 && !scratch))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (o.data) {
    if (o.wrap)
      return neumann_with<T>(dia_op<T, true>(o), v, dinv, y, scratch, rows,
                             degree, omega, device, s);
    return neumann_with<T>(dia_op<T, false>(o), v, dinv, y, scratch, rows,
                           degree, omega, device, s);
  }
  if (o.wrap)
    return neumann_with<T>(stencil_op<T, true>(o), v, dinv, y, scratch, rows,
                           degree, omega, device, s);
  return neumann_with<T>(stencil_op<T, false>(o), v, dinv, y, scratch, rows,
                         degree, omega, device, s);
}

extern "C" {

// v, y: nvec rows of n values, ldv and ldy apart (one apply: nvec = 1);
// scratch: 4 n values a vector (degree >= 2); coef_a, coef_b: degree - 1
// values each.  DIA form: data (ndiag, n), consts and strips unused.
// Stencil form: data null, consts (ndiag,), strips as in stencil_row.cuh
// (all null when grid_c == 0).  Returns a cudaError code.
#define POLY_OP_PARAMS                                                       \
  long long n, int ndiag, const long long *offsets, int wrap,               \
      const void *data, const double *consts, long long grid_c,             \
      const void *top, const void *bot, const void *left, const void *right
#define POLY_OP_ARGS \
  OpArgs { n, ndiag, offsets, wrap, data, consts, grid_c, top, bot, left, right }
#define POLY_ROWS Rows { nvec, ldv, ldy }

int cheb_apply_f64(POLY_OP_PARAMS, const void* v, void* y, void* scratch,
                   int nvec, long long ldv, long long ldy, int degree,
                   double theta, double c0, const double* coef_a,
                   const double* coef_b, int device, void* stream) {
  return cheb<double>(POLY_OP_ARGS, v, y, scratch, POLY_ROWS, degree, theta,
                      c0, coef_a, coef_b, device, stream);
}

int cheb_apply_f32(POLY_OP_PARAMS, const void* v, void* y, void* scratch,
                   int nvec, long long ldv, long long ldy, int degree,
                   double theta, double c0, const double* coef_a,
                   const double* coef_b, int device, void* stream) {
  return cheb<float>(POLY_OP_ARGS, v, y, scratch, POLY_ROWS, degree, theta,
                     c0, coef_a, coef_b, device, stream);
}

// dinv: (n,), shared by the vectors; scratch: 3 n values a vector (degree
// >= 3).
int neumann_apply_f64(POLY_OP_PARAMS, const void* v, const void* dinv, void* y,
                      void* scratch, int nvec, long long ldv, long long ldy,
                      int degree, double omega, int device, void* stream) {
  return neumann<double>(POLY_OP_ARGS, v, dinv, y, scratch, POLY_ROWS, degree,
                         omega, device, stream);
}

int neumann_apply_f32(POLY_OP_PARAMS, const void* v, const void* dinv, void* y,
                      void* scratch, int nvec, long long ldv, long long ldy,
                      int degree, double omega, int device, void* stream) {
  return neumann<float>(POLY_OP_ARGS, v, dinv, y, scratch, POLY_ROWS, degree,
                        omega, device, stream);
}

}  // extern "C"

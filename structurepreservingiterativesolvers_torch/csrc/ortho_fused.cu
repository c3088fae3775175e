// The middle pair of classical Gram-Schmidt with reorthogonalisation (CGS2)
// in one read of the Krylov basis, for Hopper (sm_90a), f64 and f32.
//
// Given the active basis Q (m rows of length n, row-major, n minor), a
// vector w and the first projection h = Q w:
//
//   w1 = w - h^T Q          (the first update)
//   u2 = Q w1               (the second projection)
//
// Replaces the TPU kernel ops/pallas_ortho.py::fused_update_matvec of the
// JAX package.  That kernel walks its column tiles in order on one core and
// carries u2 in an output block from one grid step to the next.  Blocks on
// the card run in no order, so here each block writes its own partial sums
// of u2 and a second, small kernel adds them in a fixed order.  No atomics:
// the sum takes the same order on every run, so two launches on the same
// input give the same bits and the solver's step count does not move from
// run to run.
//
// What bounds it: bytes.  Q is read once, w read once, w1 written once:
// (m n + 2 n) * sizeof(T), 145 MB in f64 at the shallow-water M=512 shape
// (n = 786,432) with m = 21, for 4 m n flops, far below the card's balance
// point.  The unfused pair of matrix-vector products reads Q twice.
//
// What the design does about it: each block walks column tiles of width BN
// in a grid-stride loop and stages the whole (m x BN) tile of Q in shared
// memory with coalesced loads (neighbouring threads on neighbouring columns
// of one row).  From that copy it forms w1 for the tile's columns (one
// thread per column, rows in order, w1 = w - sum), stores w1, and then
// forms the tile's contribution to every row of u2 (one warp per row, the
// warp's lanes over the columns, a fixed shuffle tree), added into per-row
// sums in shared memory that only that warp touches.  BN is chosen on the
// host so that the tile fits a fixed shared-memory budget, so blocks of
// several tiles stay resident on each SM.  The ragged last tile is masked
// by column index: nothing is loaded past n, and the missing columns enter
// as zeros.  Vector loads, cp.async or TMA pipelining of the next tile, and
// a split of the u2 reduction over clusters are left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define ORTHO_MAX_ROWS 128
#define ORTHO_THREADS 256
#define ORTHO_TILE_BYTES (64 * 1024)

__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  // a fixed tree: the same order on every launch
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(ORTHO_THREADS)
fused_update_matvec_kernel(const T* __restrict__ Q, long long ld,
                           const T* __restrict__ w, const T* __restrict__ h,
                           T* __restrict__ w1, T* __restrict__ partial,
                           int m, long long n, int bn_shift) {
  const int BN = 1 << bn_shift;
  extern __shared__ unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);  // (m, BN) tile
  T* sW1 = sQ + (size_t)m * BN;             // (BN,)  w1 of the tile
  T* sH = sW1 + BN;                         // (m,)   h
  T* sU = sH + m;                           // (m,)   this block's u2 sums

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = ORTHO_THREADS / 32;
  for (int r = tid; r < m; r += ORTHO_THREADS) {
    sH[r] = h[r];
    sU[r] = T(0);
  }
  const long long ntiles = (n + BN - 1) / BN;
  const int tile_elems = m * BN;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long c0 = t * BN;
    __syncthreads();  // the previous tile is consumed; h and sU are set
    // stage the tile: thread i takes row i / BN, column i % BN
#pragma unroll 4
    for (int i = tid; i < tile_elems; i += ORTHO_THREADS) {
      const int r = i >> bn_shift;
      const int cc = i & (BN - 1);
      const long long c = c0 + cc;
      sQ[i] = c < n ? Q[(long long)r * ld + c] : T(0);
    }
    __syncthreads();
    // w1 = w - sum_r h[r] Q[r, c], rows in order, one thread per column
    for (int cc = tid; cc < BN; cc += ORTHO_THREADS) {
      const long long c = c0 + cc;
      T s = T(0);
      for (int r = 0; r < m; ++r) s = fma_t(sH[r], sQ[r * BN + cc], s);
      T v = T(0);
      if (c < n) {
        v = w[c] - s;
        w1[c] = v;
      }
      sW1[cc] = v;  // zero past n: the missing columns add nothing to u2
    }
    __syncthreads();
    // u2[r] += sum_c Q[r, c] w1[c]: warp `warp` owns rows warp, warp + 8, ...
    for (int r = warp; r < m; r += nwarps) {
      const T* row = sQ + r * BN;
      T s = T(0);
      for (int cc = lane; cc < BN; cc += 32) s = fma_t(row[cc], sW1[cc], s);
      s = warp_sum(s);
      if (lane == 0) sU[r] += s;
    }
  }
  __syncthreads();
  for (int r = tid; r < m; r += ORTHO_THREADS)
    partial[(long long)blockIdx.x * m + r] = sU[r];
}

// u2[r] = sum over blocks b of partial[b, r], one block per row: each thread
// sums a fixed stride of blocks, then a fixed tree over the threads
template <typename T>
__global__ void __launch_bounds__(ORTHO_THREADS)
sum_partials_kernel(const T* __restrict__ partial, T* __restrict__ u2, int m,
                    int nblocks) {
  __shared__ T red[ORTHO_THREADS];
  const int r = blockIdx.x;
  T s = T(0);
  for (int b = threadIdx.x; b < nblocks; b += ORTHO_THREADS)
    s += partial[(long long)b * m + r];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int half = ORTHO_THREADS / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) red[threadIdx.x] += red[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) u2[r] = red[0];
}

// the widest tile of BN in {256, 128, 64, 32} columns whose (m x BN) copy
// fits ORTHO_TILE_BYTES
template <typename T>
static int tile_cols(int m) {
  int bn = 256;
  while (bn > 32 && (long long)m * bn * (long long)sizeof(T) > ORTHO_TILE_BYTES) bn >>= 1;
  return bn;
}

template <typename T>
static size_t smem_bytes(int m, int bn) {
  return ((size_t)m * bn + bn + 2 * (size_t)m) * sizeof(T);
}

// blocks of the fused kernel resident on the whole card at m rows: the grid
// of every launch at that m, so a launch's sums always take the same order.
// The attribute set and the occupancy query run once per (device, m).
template <typename T>
static int resident_blocks(int m, int device, int* out) {
  static int cache[16][ORTHO_MAX_ROWS + 1];  // 0: not queried yet
  if (device >= 0 && device < 16 && cache[device][m] > 0) {
    *out = cache[device][m];
    return 0;
  }
  const size_t smem = smem_bytes<T>(m, tile_cols<T>(m));
  // the attribute is the kernel's, not the launch's: set it to what the
  // largest tile of any m takes, so no launch ever asks above it
  const size_t most = ORTHO_TILE_BYTES + (256 + 2 * ORTHO_MAX_ROWS) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      fused_update_matvec_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fused_update_matvec_kernel<T>, ORTHO_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  *out = (per_sm > 0 ? per_sm : 1) * sms;
  if (device >= 0 && device < 16) cache[device][m] = *out;
  return 0;
}

template <typename T>
static int launch(const void* Q, long long ld, const void* w, const void* h,
                  void* w1, void* u2, void* partial, int max_blocks, int m,
                  long long n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (m < 1 || m > ORTHO_MAX_ROWS || n < 1 || ld < n || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  int blocks = 0;
  int code = resident_blocks<T>(m, device, &blocks);
  if (code != 0) return code;
  const int bn = tile_cols<T>(m);
  const long long ntiles = (n + bn - 1) / bn;
  if (blocks > ntiles) blocks = (int)ntiles;
  if (blocks > max_blocks) blocks = max_blocks;
  int shift = 0;
  while ((1 << shift) < bn) ++shift;
  cudaStream_t s = (cudaStream_t)stream;
  fused_update_matvec_kernel<T><<<blocks, ORTHO_THREADS, smem_bytes<T>(m, bn), s>>>(
      (const T*)Q, ld, (const T*)w, (const T*)h, (T*)w1, (T*)partial, m, n, shift);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<T><<<m, ORTHO_THREADS, 0, s>>>((const T*)partial, (T*)u2,
                                                     m, blocks);
  return (int)cudaGetLastError();
}

extern "C" {

int fused_update_matvec_f64(const void* Q, long long ld, const void* w,
                            const void* h, void* w1, void* u2, void* partial,
                            int max_blocks, int m, long long n, int device,
                            void* stream) {
  return launch<double>(Q, ld, w, h, w1, u2, partial, max_blocks, m, n, device,
                        stream);
}

int fused_update_matvec_f32(const void* Q, long long ld, const void* w,
                            const void* h, void* w1, void* u2, void* partial,
                            int max_blocks, int m, long long n, int device,
                            void* stream) {
  return launch<float>(Q, ld, w, h, w1, u2, partial, max_blocks, m, n, device,
                       stream);
}

}  // extern "C"

// The middle pair of classical Gram-Schmidt with reorthogonalisation (CGS2)
// in one read of the Krylov basis, for Hopper (sm_90a), f64 and f32.
//
// Given the active basis Q (m <= 128 rows of length n, row-major, n minor,
// row stride ld), a vector w and the first projection h = Q w:
//
//   w1 = w - h^T Q          (the first update)
//   u2 = Q w1               (the second projection)
//
// Replaces the TPU kernel ops/pallas_ortho.py:67 fused_update_matvec of the
// JAX package (body _kernel at :39).  That kernel walks its column tiles in
// order on one core and carries u2 in an output block from one grid step to
// the next.
//
// What bounds it: bytes.  Q is read once, w read once, w1 written once:
// (m n + 2 n) * sizeof(T), 145 MB in f64 at the shallow-water M=512 shape
// (n = 786,432) with m = 21, for 4 m n flops, far below the card's balance
// point.  The unfused pair of matrix-vector products reads Q twice.
//
// What the design does about it:
// * A persistent grid of one block an SM (ortho_plan in kernels/ortho.py
//   gives the grid G <= 132, the tile width BN and the stages S from m, n
//   and the dtype alone).  Block b takes the tiles of BN columns b, b + G,
//   b + 2 G, ... in turn, so the blocks together stream each row's columns
//   in order.  Every sum is taken in an order fixed by (n, m, dtype, the
//   plan's SM count), so two launches on the same input give the same
//   bits.  At small n the plan narrows BN (down to 32) until at least half
//   the SMs have a tile: there a block's time is its tiles' latency.
// * A ring of S >= 3 shared-memory stages, each the (m x BN) tile of Q and
//   w's BN entries.  One producer warp fills them with 1-D TMA bulk copies
//   (cp.async.bulk ... mbarrier::complete_tx::bytes), one a row segment,
//   its lanes over the rows; eight consumer warps work on one stage while
//   the next S - 1 load.  Full and empty mbarriers hand the stages back and
//   forth.  S (m + 1) (BN + 16 / sizeof(T)) sizeof(T) fits the 227 KB a
//   block may use at every m from 1 to 128.  The plan keeps S at 3 where
//   a stage holds 32 KB or more, and adds stages only up to 64 KB in
//   flight behind the one in use.
// * Alignment: a bulk copy needs a 16-byte aligned source, destination and
//   size, and nothing beyond the element size is assumed of Q, w, h or w1
//   (heat's n = 1,050,625 is odd: every other row of Q starts 8 bytes off
//   in f64).  Each row segment is copied as its 16-byte aligned superset
//   into a shared row padded by 16 bytes, and read at that row's offset.
//   Since BN sizeof(T) is a multiple of 16, the offset of row r is the same
//   in every tile: (addr(Q) + r ld sizeof(T)) mod 16, of period 2 (f64) or
//   4 (f32) in r.  A tile whose superset would pass the ends of Q or w (or
//   any tile where n sizeof(T) < 16) is loaded by the producer warp with
//   plain loads into the same layout.
// * The consumers: one thread a column forms w1 = w - sum_r h[r] Q[r, c]
//   (rows in order) into a double-buffered shared row; after a barrier of
//   the consumer warps, w1 goes out with 16-byte stores where aligned (the
//   head and tail element by element), and each warp adds Q[r, c] w1[c]
//   for its rows r = warp + 8 j into one register per row and lane (lanes
//   over the columns, in column order), across all of the block's tiles.
// * The cross-block sum in the same launch: after its last tile each warp
//   sums each row over its lanes with a fixed shuffle tree and writes the
//   block's partial; the block then fences and takes a ticket with an
//   atomicAdd on a device counter.  The block that draws the last ticket
//   adds the G partials of each row in block order (lane l over blocks
//   l, l + 32, ..., then the fixed tree), writes u2 and resets the counter
//   to 0, so the next launch and every CUDA-graph replay start clean.  One
//   launch a call.  The wrapper allocates the partials and the counter once
//   per device and dtype; two launches of this kernel never run at once on
//   one device (the port issues them on one stream), since they share the
//   counter.

#include <cuda_runtime.h>
#include <stdint.h>

#define ORTHO_MAX_ROWS 128
#define ORTHO_CONSUMER_WARPS 8
#define ORTHO_CONSUMERS (32 * ORTHO_CONSUMER_WARPS)
#define ORTHO_THREADS (ORTHO_CONSUMERS + 32)
#define ORTHO_MAX_STAGES 8
// the grid's bound: the SMs of an H100 SXM (kernels/ortho.py::SMS)
#define ORTHO_MAX_GRID 132
// the blocks' partials a lane adds in the last block
#define ORTHO_GRID_CHUNKS ((ORTHO_MAX_GRID + 31) / 32)
#define ORTHO_SMEM_MAX 232448
// the shared memory before the stages: the barriers (bytes 0-255), h
// (256-1279), then the double-buffered w1 row of 2 BN elements
#define ORTHO_H_OFFSET 256
#define ORTHO_W1_OFFSET (ORTHO_H_OFFSET + 8 * ORTHO_MAX_ROWS)

// the shared bytes of a launch: the head, then S stages of m + 1 padded rows
static inline long long ortho_smem_bytes(int m, int bn, int stages, int size) {
  const long long head = (ORTHO_W1_OFFSET + 2LL * bn * size + 127) / 128 * 128;
  return head + (long long)stages * (m + 1) * ((long long)bn * size + 16);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n\t}" ::"r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n\t}" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// wait until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// a barrier of the consumer warps only (the producer warp never joins)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(ORTHO_CONSUMERS) : "memory");
}

__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  // a fixed tree: the same order on every launch; lane 0 holds the sum
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// the offset (elements) of row r's segment in its 16-byte aligned superset:
// (addr(Q) + r ld sizeof(T)) mod 16, whatever the tile (BN sizeof(T) is a
// multiple of 16), of period 4 in r
template <typename T>
__device__ __forceinline__ int row_off(int qa16, int ldm, int r) {
  return ((qa16 + (r & 3) * ldm) & 15) / (int)sizeof(T);
}

// 16 bytes of T, for the stores of w1
template <typename T> struct Vec16;
template <> struct Vec16<double> { typedef double2 type; };
template <> struct Vec16<float> { typedef float4 type; };

template <typename T>
__device__ __forceinline__ void store16(T* dst, const T* src) {
  typedef typename Vec16<T>::type V;
  V v;
  T* p = reinterpret_cast<T*>(&v);
#pragma unroll
  for (int e = 0; e < (int)(16 / sizeof(T)); ++e) p[e] = src[e];
  *reinterpret_cast<V*>(dst) = v;
}

// RPW: the rows of u2 each consumer warp accumulates (rows warp + 8 j,
// j < RPW), one register each a lane: ceil(m / 8) rounded up to a power of
// two, so that a warp carries no more than twice the registers it uses
template <typename T, int RPW>
__global__ void __launch_bounds__(ORTHO_THREADS, 1)
fused_update_matvec_kernel(const T* __restrict__ Q, long long ld,
                           const T* __restrict__ w, const T* __restrict__ h,
                           T* __restrict__ w1, T* __restrict__ u2,
                           T* __restrict__ partial,
                           unsigned int* __restrict__ counter, int m,
                           long long n, int bn, int stages) {
  constexpr int SZ = (int)sizeof(T);
  constexpr int PAD = 16 / SZ;  // elements of a shared row's padding
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + ORTHO_MAX_STAGES;
  int* last_flag = reinterpret_cast<int*>(empty + ORTHO_MAX_STAGES);
  T* sH = reinterpret_cast<T*>(smem_raw + ORTHO_H_OFFSET);
  T* sW1 = reinterpret_cast<T*>(smem_raw + ORTHO_W1_OFFSET);
  const long long head =
      (ORTHO_W1_OFFSET + 2LL * bn * SZ + 127) / 128 * 128;
  T* stage0 = reinterpret_cast<T*>(smem_raw + head);
  const int rs = bn + PAD;                     // elements of a shared row
  const int stage_elems = (m + 1) * rs;    // at most 29,056 (227 KB of f64)

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long G = gridDim.x;
  // this block's tiles: b, b + G, b + 2 G, ... of BN columns from column 0
  const long long c_first = (long long)blockIdx.x * bn;
  const long long step = G * bn;

  // the offset (elements) of row r's data in its shared row: the same in
  // every tile, of period 4 in r; w's
  const uintptr_t qa = reinterpret_cast<uintptr_t>(Q);
  const uintptr_t wa = reinterpret_cast<uintptr_t>(w);
  const int qa16 = (int)(qa & 15);
  const int ldm = (int)((ld * SZ) & 15);
  const int o0 = row_off<T>(qa16, ldm, 0), o1 = row_off<T>(qa16, ldm, 1);
  const int o2 = row_off<T>(qa16, ldm, 2), o3 = row_off<T>(qa16, ldm, 3);
  const int woff = (int)(wa & 15) / SZ;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 32);                    // every producer lane
      mbar_init(&empty[s], ORTHO_CONSUMER_WARPS);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int r = tid; r < m; r += ORTHO_THREADS) sH[r] = h[r];
  __syncthreads();

  if (warp == ORTHO_CONSUMER_WARPS) {
    // the producer warp: fill stage i % S with the block's tile i
    const uintptr_t qend = qa + (uintptr_t)(((long long)(m - 1) * ld + n) * SZ);
    const uintptr_t wend = wa + (uintptr_t)(n * SZ);
    const bool wide = n * SZ >= 16;
    int i = 0;
    for (long long c0 = c_first; c0 < n; c0 += step, ++i) {
      const int s = i % stages;
      const uint32_t round = (uint32_t)(i / stages);
      mbar_wait(&empty[s], (round & 1) ^ 1);
      const int cols = (int)(n - c0 < bn ? n - c0 : bn);
      T* stage = stage0 + s * stage_elems;
      // the aligned supersets of row 0's and row m - 1's segments, and w's
      const uintptr_t q_lo = (qa + (uintptr_t)(c0 * SZ)) & ~(uintptr_t)15;
      const uintptr_t q_hi =
          (qa + (uintptr_t)(((long long)(m - 1) * ld + c0 + cols) * SZ) + 15) &
          ~(uintptr_t)15;
      const uintptr_t w_lo = (wa + (uintptr_t)(c0 * SZ)) & ~(uintptr_t)15;
      const uintptr_t w_hi =
          (wa + (uintptr_t)((c0 + cols) * SZ) + 15) & ~(uintptr_t)15;
      const bool bulk = wide && q_lo >= qa && q_hi <= qend && w_lo >= wa &&
                        w_hi <= wend;
      if (bulk) {
        uint32_t bytes = 0;
        for (int r = lane; r <= m; r += 32) {
          const uintptr_t a = (r < m ? qa + (uintptr_t)(r * ld * SZ) : wa) +
                              (uintptr_t)(c0 * SZ);
          const uintptr_t lo = a & ~(uintptr_t)15;
          bytes += (uint32_t)(((a + (uintptr_t)cols * SZ + 15) & ~(uintptr_t)15) - lo);
        }
        mbar_arrive_tx(&full[s], bytes);
        for (int r = lane; r <= m; r += 32) {
          const uintptr_t a = (r < m ? qa + (uintptr_t)(r * ld * SZ) : wa) +
                              (uintptr_t)(c0 * SZ);
          const uintptr_t lo = a & ~(uintptr_t)15;
          const uint32_t size =
              (uint32_t)(((a + (uintptr_t)cols * SZ + 15) & ~(uintptr_t)15) - lo);
          bulk_load(stage + r * rs, reinterpret_cast<const void*>(lo),
                    size, &full[s]);
        }
      } else {
        // plain loads into the same layout
        for (int r = 0; r <= m; ++r) {
          const T* src = (r < m ? Q + (long long)r * ld : w) + c0;
          T* dst = stage + r * rs +
                   (r < m ? row_off<T>(qa16, ldm, r) : woff);
#pragma unroll 4
          for (int cc = lane; cc < cols; cc += 32) dst[cc] = src[cc];
        }
        // order these generic-proxy writes before later bulk copies into
        // the stage
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // the consumer warps
  const int ow = row_off<T>(qa16, ldm, warp);
  T acc[RPW];
#pragma unroll
  for (int j = 0; j < RPW; ++j) acc[j] = T(0);
  // w1's stores: the elements before the first 16-byte boundary (the same
  // in every tile, since BN sizeof(T) is a multiple of 16)
  const int w1_head =
      (reinterpret_cast<uintptr_t>(w1) % SZ)
          ? -1
          : (int)((16 - (reinterpret_cast<uintptr_t>(w1) & 15)) & 15) / SZ;
  int i = 0;
  for (long long c0 = c_first; c0 < n; c0 += step, ++i) {
    const int s = i % stages;
    const uint32_t round = (uint32_t)(i / stages);
    mbar_wait(&full[s], round & 1);
    const int cols = (int)(n - c0 < bn ? n - c0 : bn);
    const T* stage = stage0 + s * stage_elems;
    T* sw = sW1 + (i & 1) * bn;
    // w1 = w - sum_r h[r] Q[r, c], rows in order, one thread a column
    for (int cc = tid; cc < cols; cc += ORTHO_CONSUMERS) {
      const T* col = stage + cc;
      T acc1 = T(0);
      int r = 0;
      for (; r + 4 <= m; r += 4) {
        acc1 = fma_t(sH[r], col[r * rs + o0], acc1);
        acc1 = fma_t(sH[r + 1], col[(r + 1) * rs + o1], acc1);
        acc1 = fma_t(sH[r + 2], col[(r + 2) * rs + o2], acc1);
        acc1 = fma_t(sH[r + 3], col[(r + 3) * rs + o3], acc1);
      }
      for (; r < m; ++r)
        acc1 = fma_t(sH[r], col[r * rs + row_off<T>(qa16, ldm, r)], acc1);
      sw[cc] = col[m * rs + woff] - acc1;
    }
    consumers_sync();
    // w1 out: 16-byte stores where aligned, the head and tail one by one
    T* dst = w1 + c0;
    if (w1_head < 0) {
      for (int e = tid; e < cols; e += ORTHO_CONSUMERS) dst[e] = sw[e];
    } else {
      const int hd = w1_head < cols ? w1_head : cols;
      constexpr int VEC = 16 / SZ;
      const int nvec = (cols - hd) / VEC;
      if (tid < hd) dst[tid] = sw[tid];
      for (int v = tid; v < nvec; v += ORTHO_CONSUMERS)
        store16(dst + hd + v * VEC, sw + hd + v * VEC);
      const int tail = hd + nvec * VEC + tid;
      if (tail < cols) dst[tail] = sw[tail];
    }
    // u2 += Q w1 over this tile: warp rows warp + 8 j (all at the offset
    // of row `warp`, since 8 j is a multiple of the period), lanes over
    // columns
    const T* rows = stage + warp * rs + ow;
    for (int cc = lane; cc < cols; cc += 32) {
      const T x = sw[cc];
#pragma unroll
      for (int j = 0; j < RPW; ++j) {
        if (warp + ORTHO_CONSUMER_WARPS * j < m)
          acc[j] = fma_t(rows[ORTHO_CONSUMER_WARPS * j * rs + cc], x, acc[j]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // this block's partial of each row, then the ticket
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    const int r = warp + ORTHO_CONSUMER_WARPS * j;
    const T v = warp_sum(acc[j]);
    if (r < m && lane == 0) partial[(long long)blockIdx.x * m + r] = v;
  }
  __threadfence();
  consumers_sync();
  if (tid == 0) {
    const unsigned int ticket = atomicAdd(counter, 1u);
    *last_flag = ticket == (unsigned int)(G - 1);
  }
  consumers_sync();
  if (!*last_flag) return;
  // the last block: every partial is visible; sum each row in block order,
  // lane l over blocks l, l + 32, ... (each row's loads issued together)
  __threadfence();
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    const int r = warp + ORTHO_CONSUMER_WARPS * j;
    if (r < m) {  // warp-uniform
      T part[ORTHO_GRID_CHUNKS];
#pragma unroll
      for (int q = 0; q < ORTHO_GRID_CHUNKS; ++q) {
        const long long b = lane + 32 * q;
        part[q] = b < G ? __ldcg(&partial[b * m + r]) : T(0);
      }
      T v = T(0);
#pragma unroll
      for (int q = 0; q < ORTHO_GRID_CHUNKS; ++q) v += part[q];
      v = warp_sum(v);
      if (lane == 0) u2[r] = v;
    }
  }
  if (tid == 0) *counter = 0u;  // the next launch starts clean
}

// the dynamic shared-memory attribute of each instantiation, once a device
template <typename T, int RPW>
static int allow_smem(int device) {
  static bool set[64];
  if (device >= 0 && device < 64 && set[device]) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      fused_update_matvec_kernel<T, RPW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, ORTHO_SMEM_MAX);
  if (err != cudaSuccess) return (int)err;
  if (device >= 0 && device < 64) set[device] = true;
  return 0;
}

template <typename T, int RPW>
static int launch_rpw(const void* Q, long long ld, const void* w,
                      const void* h, void* w1, void* u2, void* partial,
                      void* counter, int m, long long n, int bn, int stages,
                      int grid, int smem, int device, cudaStream_t s) {
  int code = allow_smem<T, RPW>(device);
  if (code != 0) return code;
  fused_update_matvec_kernel<T, RPW><<<grid, ORTHO_THREADS, smem, s>>>(
      (const T*)Q, ld, (const T*)w, (const T*)h, (T*)w1, (T*)u2, (T*)partial,
      (unsigned int*)counter, m, n, bn, stages);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* Q, long long ld, const void* w, const void* h,
                  void* w1, void* u2, void* partial, long long partial_cap,
                  void* counter, int m, long long n, int bn, int stages,
                  int grid, int smem, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long ntiles = bn > 0 ? (n + bn - 1) / bn : 0;
  if (m < 1 || m > ORTHO_MAX_ROWS || n < 1 || ld < n || bn < 32 || bn % 32 ||
      stages < 2 || stages > ORTHO_MAX_STAGES || grid < 1 || grid > ntiles ||
      grid > ORTHO_MAX_GRID ||
      (long long)grid * m > partial_cap || smem > ORTHO_SMEM_MAX ||
      smem < ortho_smem_bytes(m, bn, stages, (int)sizeof(T)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (m <= 8)
    return launch_rpw<T, 1>(Q, ld, w, h, w1, u2, partial, counter, m, n, bn,
                            stages, grid, smem, device, s);
  if (m <= 16)
    return launch_rpw<T, 2>(Q, ld, w, h, w1, u2, partial, counter, m, n, bn,
                            stages, grid, smem, device, s);
  if (m <= 32)
    return launch_rpw<T, 4>(Q, ld, w, h, w1, u2, partial, counter, m, n, bn,
                            stages, grid, smem, device, s);
  if (m <= 64)
    return launch_rpw<T, 8>(Q, ld, w, h, w1, u2, partial, counter, m, n, bn,
                            stages, grid, smem, device, s);
  return launch_rpw<T, 16>(Q, ld, w, h, w1, u2, partial, counter, m, n, bn,
                           stages, grid, smem, device, s);
}

extern "C" {

// the shared bytes of a launch at (m, bn, stages) for elements of `size`
// bytes: kernels/ortho.py::ortho_plan computes the same
long long fused_update_matvec_smem(int m, int bn, int stages, int size) {
  return ortho_smem_bytes(m, bn, stages, size);
}

int fused_update_matvec_f64(const void* Q, long long ld, const void* w,
                            const void* h, void* w1, void* u2, void* partial,
                            long long partial_cap, void* counter, int m,
                            long long n, int bn, int stages, int grid,
                            int smem, int device, void* stream) {
  return launch<double>(Q, ld, w, h, w1, u2, partial, partial_cap, counter, m,
                        n, bn, stages, grid, smem, device, stream);
}

int fused_update_matvec_f32(const void* Q, long long ld, const void* w,
                            const void* h, void* w1, void* u2, void* partial,
                            long long partial_cap, void* counter, int m,
                            long long n, int bn, int stages, int grid,
                            int smem, int device, void* stream) {
  return launch<float>(Q, ld, w, h, w1, u2, partial, partial_cap, counter, m,
                       n, bn, stages, grid, smem, device, stream);
}

}  // extern "C"

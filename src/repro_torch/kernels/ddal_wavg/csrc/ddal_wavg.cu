// DDAL eq. 4 share step for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/ddal_wavg/kernel.py:
//   * fused_wavg_flat (:164, body _fused_wavg_kernel :101) — ddal_fused_wavg:
//     rebuilds w = ½(T̂ + R̂) from the raw (T, R, valid) metadata inside the
//     kernel and writes (ḡ, Σw);
//   * wavg_flat (:58, body _wavg_kernel :48) — ddal_wavg: the same
//     contraction with the weights computed outside;
//   * fused_wavg_q_flat (:185, body _fused_wavg_q_kernel :118) —
//     ddal_fused_wavg_q: the fused step over int8 planes with fp32 per-block
//     scales, dequantised inside the loop as acc + w_j·(q·s).
//
// Shapes: G (n, m, P) fp32 contiguous — n agents' stores of m flat pieces —
// or Q (n, m, P) int8 with scale (n, m, nb) fp32 and cols (P,) int32, the
// scale column of each position (the int8 blocks restart at every leaf of the
// flat row, so the column is not p / q_block); T, R (n, m) fp32, valid (n, m)
// bool (one byte each), or w (n, m) fp32; out ḡ (n, P) fp32, Σw (n,) fp32.
//
// Bound: bytes. Each element of G (Q) is read once and used for one
// multiply-add (two multiplies and an add for int8), 0.5 FLOP per byte of
// fp32 (3 per byte of int8) against the card's ~20 FLOP/byte fp32 balance, so
// the least time is the bytes of G (Q and its scales), the metadata and ḡ
// over the HBM rate. At the main path's sizes (a few MB) the least time is
// under a microsecond, so what a design has to fight is latency: the chain
// of dependent steps in one block, and how many blocks share the card.
//
// Both kernels follow one design, whose geometry the wrapper computes
// (ops.py::wavg_geometry, ::wavg_q_geometry) and passes in: one position
// per thread in 64-thread blocks (1,152 blocks at (8, 32, 9155), 288 at
// (2, 32, 9155)), several per thread only where the grid still holds
// several blocks per SM (long planes with few pieces); every load of a
// batch of pieces issued into registers before the ordered fold; the eq. 4
// weights built by one warp from registers while those loads are in flight
// (warp_eq4_weights). What bounds them at the main path's sizes is one
// dependent trip to memory per thread plus the weights' chain of ordered
// adds; on long planes, the bytes in flight per SM.
//
// fp32 kernel (wavg_kernel): a batch's G values in registers, up to 32 per
// thread; the fused entry's weights built by a warp of its own and passed
// through shared memory behind one barrier, the given weights of the wavg
// entry read one per lane and broadcast by shuffles, with no barrier.
//
// int8 kernel (wavg_q_kernel): a batch's q bytes and scales in registers
// (see the comment above the kernel). Each position's scale column is read
// once from cols; a warp's 32 positions share one or two scales, a
// broadcast.
//
// P is the A2C parameter count (odd), so rows are not 16-byte aligned: loads
// stay scalar and the ragged end is masked, with no padding copy.
//
// Arithmetic: the weights follow eq4_weights' op order (mask, sum left to
// right from 0, clamp at 1e-12, divide, ½(t̂ + r̂)) and the accumulation is
// acc ← acc + w_j·G[j] (int8: acc ← acc + w_j·(q_j·s_j), the Pallas kernel's
// order) for j = 0..m-1, each a separately rounded fp32 multiply and add (no
// FMA contraction), so the plain PyTorch version in ref.py, which performs the
// same ops in the same order, gives the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float EQ4_EPS = 1e-12f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float clamp_min(float x, float lo) {
  // NaN propagates, as torch.clamp_min / jnp.maximum do
  return x < lo ? lo : x;
}

// The eq. 4 weights of one agent's m pieces into w_s (shared), and its Σw
// into wsum[agent] when `sum_w` is set, by the 32 lanes of one warp. The op
// order is eq4_weights': mask (T·v, R·v), sums left to right from 0, clamp
// at 1e-12, divide, ½(t̂ + r̂); Σw left to right from 0. Lane k holds piece
// base + k of each round of 32; the sums take the lanes' values through
// shuffles, which do not depend on the running sum, so only the adds are a
// chain. (t0, r0) are round 0's masked values, loaded by the caller early.
// UNROLLED (the fp32 kernel) unrolls each full round of 32 of the sums in
// straight-line code, so the shuffles run ahead of the adds; without it (the
// int8 kernel, as it was measured) a round is a loop of 8-step bodies in
// which every shuffle waits for its own convergence check.
template <bool UNROLLED = false>
__device__ void warp_eq4_weights(const float* __restrict__ T,
                                 const float* __restrict__ R,
                                 const uint8_t* __restrict__ valid,
                                 float t0, float r0, long long meta, int m,
                                 float* w_s, bool sum_w,
                                 float* __restrict__ wsum, int agent) {
  const int lane = threadIdx.x & 31;
  float st = 0.f, sr = 0.f;
  for (int base = 0; base < m; base += 32) {
    float t = t0, r = r0;
    if (base > 0) {
      const int j = base + lane;
      t = r = 0.f;
      if (j < m) {
        const float v = valid[meta + j] ? 1.f : 0.f;
        t = __fmul_rn(__ldg(T + meta + j), v);
        r = __fmul_rn(__ldg(R + meta + j), v);
      }
    }
    const int count = min(32, m - base);
    if (UNROLLED && count == 32) {
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        st = __fadd_rn(st, __shfl_sync(FULL, t, k));
        sr = __fadd_rn(sr, __shfl_sync(FULL, r, k));
      }
    } else {
#pragma unroll 8
      for (int k = 0; k < count; ++k) {
        st = __fadd_rn(st, __shfl_sync(FULL, t, k));
        sr = __fadd_rn(sr, __shfl_sync(FULL, r, k));
      }
    }
  }
  st = clamp_min(st, EQ4_EPS);
  sr = clamp_min(sr, EQ4_EPS);
  float sw = 0.f;
  for (int base = 0; base < m; base += 32) {
    const int j = base + lane;
    float t = t0, r = r0;
    if (base > 0) {
      t = r = 0.f;
      if (j < m) {
        const float v = valid[meta + j] ? 1.f : 0.f;
        t = __fmul_rn(__ldg(T + meta + j), v);
        r = __fmul_rn(__ldg(R + meta + j), v);
      }
    }
    const float w = __fmul_rn(0.5f, __fadd_rn(__fdiv_rn(t, st),
                                              __fdiv_rn(r, sr)));
    if (j < m) w_s[j] = w;
    if (sum_w) {
      const int count = min(32, m - base);
#pragma unroll 8
      for (int k = 0; k < count; ++k)
        sw = __fadd_rn(sw, __shfl_sync(FULL, w, k));
    }
  }
  if (sum_w && lane == 0) wsum[agent] = sw;
}

// ---------------------------------------------------------------------
// The fp32 share step.
//
// Block b of agent a takes the ITEMS · 64 positions from b · ITEMS · 64 on,
// thread t the positions t, t + 64, ... (so each load instruction of a warp
// reads 128 neighbouring bytes). The wrapper (ops.py::wavg_geometry) picks
// BATCH, the pieces held in registers at a time (8, 16 or 32: the least
// that covers m, 32 past that), and ITEMS (32 / BATCH where the grid still
// holds 4 blocks per SM, else 1), so a thread holds at most 32 G values:
// (2, 32, 9155) gives 288 blocks and (8, 32, 9155) 1,152, one position per
// thread; the big plane (16, 8, 2^20 + 37) 65,552, four per thread. The
// launch bounds keep 9 blocks resident per SM (1,188 on the card: the main
// path's 1,152 in one wave): 96 registers a thread for the wavg entry's
// 64-thread blocks, 72 for the fused entry's 96.
// The fused entry's blocks have a third warp, the weigher: it loads the
// metadata and builds the eq. 4 weights in registers (warp_eq4_weights:
// sums folded from shuffled registers, in order) while the other two warps'
// G loads of the first BATCH pieces are in flight, and publishes them in
// shared memory; after one barrier it leaves, and every other thread folds
// its BATCH pieces in j order, summing Σw beside (block 0's thread 0 writes
// it). On warp 0 the chain of adds would have started only after that warp
// had issued its own G loads. The wavg entry, whose weights are given, has
// lane k load w_j of piece base + k before the G loads and broadcasts it by
// a shuffle in the fold, so its warps never wait on each other. Pieces past
// the first BATCH follow in further batches (m up to MAX_PIECES). A thread
// past P loads nothing but still reaches the barrier and the shuffles; its
// liveness stays out of the j loop.

constexpr int F32_THREADS = 64;       // threads per block that fold
constexpr int F32_MIN_BLOCKS = 9;     // resident per SM

// One batch's G values at this thread's positions, piece k from
// row + k·P; pieces from `count` on (and dead positions) read 0. Called
// with count = BATCH for a full batch, so the loads carry no piece guard.
template <int BATCH, int ITEMS>
__device__ __forceinline__ void load_batch(float (&gv)[ITEMS][BATCH],
                                           const float* row, long long P,
                                           const bool (&live)[ITEMS],
                                           int count) {
#pragma unroll
  for (int k = 0; k < BATCH; ++k, row += P) {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)
      gv[i][k] = (live[i] && k < count) ? __ldg(row + i * F32_THREADS) : 0.f;
  }
}

// acc ← acc + w_k·gv[k] for k = 0..count-1, in order; w_k from shared
// memory (fused, which also runs Σw ← Σw + w_k beside it: the same sum
// from 0 in the same order as eq. 4's) or from lane k's wl. Called with
// count = BATCH for a full batch: then no step sits behind a branch, and
// the weight reads run ahead of the chain of adds.
template <int BATCH, int ITEMS, bool FUSED>
__device__ __forceinline__ void fold_batch(float (&acc)[ITEMS], float& sw,
                                           const float (&gv)[ITEMS][BATCH],
                                           const float* w, float wl,
                                           int count) {
#pragma unroll
  for (int k = 0; k < BATCH; ++k) {
    if (k < count) {
      const float wj = FUSED ? w[k] : __shfl_sync(FULL, wl, k);
      if (FUSED) sw = __fadd_rn(sw, wj);
#pragma unroll
      for (int i = 0; i < ITEMS; ++i)
        acc[i] = __fadd_rn(acc[i], __fmul_rn(wj, gv[i][k]));
    }
  }
}

template <int BATCH, int ITEMS, bool FUSED>
__global__ void __launch_bounds__(F32_THREADS + (FUSED ? 32 : 0),
                                  F32_MIN_BLOCKS)
wavg_kernel(const float* __restrict__ G, const float* __restrict__ T,
            const float* __restrict__ R, const uint8_t* __restrict__ valid,
            const float* __restrict__ w_in, float* __restrict__ out,
            float* __restrict__ wsum, int m, long long P) {
  extern __shared__ float w_s[];     // fused: this agent's m weights
  const int agent = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const long long meta = (long long)agent * m;
  // (fused) the block's last warp builds the weights and folds nothing
  const bool weigher = FUSED && threadIdx.x >= F32_THREADS;
  // this thread's positions are p0 + i·F32_THREADS: one row pointer per
  // piece, and the items at immediate offsets from it
  const long long p0 =
      (long long)blockIdx.x * (F32_THREADS * ITEMS) + threadIdx.x;
  const float* g = G + meta * P + p0;
  bool live[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) live[i] = p0 + i * F32_THREADS < P;

  // 1. (fused) the weigher builds the eq. 4 weights into shared memory
  //    while the other threads' loads are in flight: (wavg) lane k's
  //    weight of piece k, then the first batch's G values
  int count = min(m, BATCH);
  float wl = 0.f;
  float gv[ITEMS][BATCH];
  if (weigher) {
    float t0 = 0.f, r0 = 0.f;
    if (lane < m) {
      const float v = valid[meta + lane] ? 1.f : 0.f;
      t0 = __fmul_rn(__ldg(T + meta + lane), v);
      r0 = __fmul_rn(__ldg(R + meta + lane), v);
    }
    warp_eq4_weights<true>(T, R, valid, t0, r0, meta, m, w_s, false,
                           nullptr, agent);
  } else {
    if (!FUSED && lane < count) wl = __ldg(w_in + meta + lane);
    if (count == BATCH)
      load_batch<BATCH, ITEMS>(gv, g, P, live, BATCH);
    else
      load_batch<BATCH, ITEMS>(gv, g, P, live, count);
  }
  if (FUSED) {
    __syncthreads();
    if (weigher) return;
  }

  // 2. the fold, j = 0, 1, 2, ... per position, one batch at a time
  float acc[ITEMS];
  float sw = 0.f;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) acc[i] = 0.f;
  for (int base = 0;;) {
    if (count == BATCH)
      fold_batch<BATCH, ITEMS, FUSED>(acc, sw, gv, w_s + base, wl, BATCH);
    else
      fold_batch<BATCH, ITEMS, FUSED>(acc, sw, gv, w_s + base, wl, count);
    base += BATCH;
    if (base >= m) break;
    count = min(m - base, BATCH);
    const float* row = g + (long long)base * P;
    if (count == BATCH)
      load_batch<BATCH, ITEMS>(gv, row, P, live, BATCH);
    else
      load_batch<BATCH, ITEMS>(gv, row, P, live, count);
    if (!FUSED) wl = lane < count ? __ldg(w_in + meta + base + lane) : 0.f;
  }
  float* o = out + (long long)agent * P + p0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i)
    if (live[i]) o[i * F32_THREADS] = acc[i];
  if (FUSED && blockIdx.x == 0 && threadIdx.x == 0) wsum[agent] = sw;
}

// Launches the instance of (batch, items); cudaErrorInvalidValue for a
// geometry that has none.
template <bool FUSED>
cudaError_t launch_wavg(int batch, int items, dim3 grid, int m,
                        cudaStream_t stream, const float* G, const float* T,
                        const float* R, const uint8_t* valid, const float* w,
                        float* out, float* wsum, long long P) {
  const size_t smem = FUSED ? m * sizeof(float) : 0;
  const int threads = F32_THREADS + (FUSED ? 32 : 0);
#define WAVG(B, I)                                                          \
  if (batch == B && items == I) {                                           \
    wavg_kernel<B, I, FUSED><<<grid, threads, smem, stream>>>(              \
        G, T, R, valid, w, out, wsum, m, P);                                \
    return cudaGetLastError();                                              \
  }
  WAVG(32, 1) WAVG(16, 1) WAVG(16, 2) WAVG(8, 1) WAVG(8, 4)
#undef WAVG
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------
// The int8 share step: the fp32 kernel's geometry (ops.py::wavg_q_geometry
// picks BATCH and ITEMS by the same rule) and launch bounds, but each load
// instruction of a warp reads 32 neighbouring bytes, and a batch's q bytes
// and scales in flight take 64 registers per position: ptxas spills a few
// bytes to L1 in the instances that hold 32 values per position (PERF.md §6
// has the counts). 96 registers a thread are what 9 resident blocks leave
// (18 warps, 5 on each of the SM's four 16,384-register schedulers).
// Each thread first issues its scale-column loads and the q bytes of the
// first BATCH pieces; warp 0 issues the first 32 pieces' metadata loads;
// then each thread issues its BATCH scale loads per position (which wait on
// the column). Only then does warp 0 build the eq. 4 weights in registers
// and publish them in shared memory; after one barrier every thread folds
// its BATCH pieces in j order into one accumulator per position, batch
// after batch, as the fp32 kernel does.

constexpr int Q_THREADS = 64;         // threads per block
constexpr int Q_MIN_BLOCKS = 9;       // resident per SM: ≤ 96 registers

template <int BATCH, int ITEMS>
__global__ void __launch_bounds__(Q_THREADS, Q_MIN_BLOCKS)
wavg_q_kernel(const int8_t* __restrict__ Q, const float* __restrict__ scale,
              const int* __restrict__ cols, const float* __restrict__ T,
              const float* __restrict__ R, const uint8_t* __restrict__ valid,
              float* __restrict__ out, float* __restrict__ wsum, int m,
              long long P, int nb) {
  extern __shared__ float w_s[];     // this agent's m weights
  const int agent = blockIdx.y;
  const long long meta = (long long)agent * m;
  // this thread's positions are p0 + i·Q_THREADS: one row pointer per
  // piece, and the items at immediate offsets from it
  const long long p0 =
      (long long)blockIdx.x * (Q_THREADS * ITEMS) + threadIdx.x;
  const int8_t* q = Q + meta * P + p0;
  const float* s = scale + meta * nb;
  const bool stager = threadIdx.x < 32;
  bool live[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) live[i] = p0 + i * Q_THREADS < P;

  // 1. the loads that need nothing: the scale columns, the first batch's q
  //    bytes, and (warp 0) the first round's metadata
  int col[ITEMS];
  int qv[ITEMS][BATCH];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i)
    col[i] = live[i] ? __ldg(cols + p0 + i * Q_THREADS) : 0;
#pragma unroll
  for (int k = 0; k < BATCH; ++k) {
    const int8_t* row = q + (long long)k * P;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)
      qv[i][k] = (live[i] && k < m) ? (int)__ldg(row + i * Q_THREADS) : 0;
  }
  float t0 = 0.f, r0 = 0.f;
  if (stager && (int)threadIdx.x < m) {
    const float v = valid[meta + threadIdx.x] ? 1.f : 0.f;
    t0 = __fmul_rn(__ldg(T + meta + threadIdx.x), v);
    r0 = __fmul_rn(__ldg(R + meta + threadIdx.x), v);
  }
  // 2. the first batch's scales, which wait on the columns
  float sv[ITEMS][BATCH];
#pragma unroll
  for (int k = 0; k < BATCH; ++k) {
    const float* srow = s + (long long)k * nb;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)
      sv[i][k] = (live[i] && k < m) ? __ldg(srow + col[i]) : 0.f;
  }
  // 3. the weights, while those loads are in flight
  if (stager)
    warp_eq4_weights(T, R, valid, t0, r0, meta, m, w_s, blockIdx.x == 0,
                     wsum, agent);
  __syncthreads();

  // 4. the fold, j = 0, 1, 2, ... per position, one batch at a time
  float acc[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) acc[i] = 0.f;
  for (int base = 0;;) {
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      if (base + k < m) {
        const float wj = w_s[base + k];
#pragma unroll
        for (int i = 0; i < ITEMS; ++i) {
          const float x = __fmul_rn((float)qv[i][k], sv[i][k]);
          acc[i] = __fadd_rn(acc[i], __fmul_rn(wj, x));
        }
      }
    }
    base += BATCH;
    if (base >= m) break;
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int8_t* row = q + (long long)(base + k) * P;
#pragma unroll
      for (int i = 0; i < ITEMS; ++i)
        qv[i][k] = (live[i] && base + k < m)
                       ? (int)__ldg(row + i * Q_THREADS) : 0;
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const float* srow = s + (long long)(base + k) * nb;
#pragma unroll
      for (int i = 0; i < ITEMS; ++i)
        sv[i][k] = (live[i] && base + k < m) ? __ldg(srow + col[i]) : 0.f;
    }
  }
  float* o = out + (long long)agent * P + p0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i)
    if (live[i]) o[i * Q_THREADS] = acc[i];
}

template <int BATCH, int ITEMS>
cudaError_t launch_wavg_q(dim3 grid, int m, cudaStream_t stream,
                          const int8_t* Q, const float* scale,
                          const int* cols, const float* T, const float* R,
                          const uint8_t* valid, float* out, float* wsum,
                          long long P, int nb) {
  wavg_q_kernel<BATCH, ITEMS><<<grid, Q_THREADS, m * sizeof(float),
                                stream>>>(Q, scale, cols, T, R, valid, out,
                                          wsum, m, P, nb);
  return cudaGetLastError();
}

}  // namespace

// The entry points make `device` current (this library links its own CUDA
// runtime, whose current device is not PyTorch's), launch on `stream`, do
// not synchronise and return the launch status for the caller to check.
// Each takes its launch geometry from the caller (ops.py::wavg_geometry,
// ::wavg_q_geometry): `items` positions per thread and `batch` pieces per
// batch (one of the instances above), and `blocks` = ⌈P / (64 · items)⌉
// blocks per agent; a geometry that does not cover P is refused.
extern "C" int ddal_fused_wavg(const float* G, const float* T, const float* R,
                               const uint8_t* valid, float* out, float* wsum,
                               int n, int m, long long P, int items,
                               int batch, int blocks, int device,
                               cudaStream_t stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if ((long long)blocks * F32_THREADS * items < P)
    return (int)cudaErrorInvalidConfiguration;
  return (int)launch_wavg<true>(batch, items, dim3((unsigned)blocks,
                                                   (unsigned)n),
                                m, stream, G, T, R, valid, nullptr, out,
                                wsum, P);
}

extern "C" int ddal_wavg(const float* G, const float* w, float* out, int n,
                         int m, long long P, int items, int batch,
                         int blocks, int device, cudaStream_t stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if ((long long)blocks * F32_THREADS * items < P)
    return (int)cudaErrorInvalidConfiguration;
  return (int)launch_wavg<false>(batch, items, dim3((unsigned)blocks,
                                                    (unsigned)n),
                                 m, stream, G, nullptr, nullptr, nullptr, w,
                                 out, nullptr, P);
}

extern "C" int ddal_fused_wavg_q(const int8_t* Q, const float* scale,
                                 const int* cols, const float* T,
                                 const float* R, const uint8_t* valid,
                                 float* out, float* wsum, int n, int m,
                                 long long P, int nb, int items, int batch,
                                 int blocks, int device,
                                 cudaStream_t stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if ((long long)blocks * Q_THREADS * items < P)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks, (unsigned)n);
#define WAVG_Q(B, I)                                                      \
  if (batch == B && items == I)                                           \
    return (int)launch_wavg_q<B, I>(grid, m, stream, Q, scale, cols, T, R, \
                                    valid, out, wsum, P, nb);
  WAVG_Q(32, 1) WAVG_Q(16, 1) WAVG_Q(16, 2) WAVG_Q(8, 1) WAVG_Q(8, 4)
#undef WAVG_Q
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ddal_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

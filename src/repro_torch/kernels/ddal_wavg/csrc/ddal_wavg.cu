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
// fp32 kernels (wavg_kernel): read G once, in coalesced rows (neighbouring
// threads on neighbouring elements of one piece), keep ITEMS fp32
// accumulators per thread in registers for the whole j loop (unrolled, so
// several pieces' loads are in flight) and write ḡ once. One launch covers
// every agent: grid (⌈P / TILE⌉, n), and a TILE of 512 gives the
// quickstart's small planes (P = 9155) 18 blocks per agent.
//
// int8 kernel (wavg_q_kernel): one position per thread in small blocks whose
// size the wrapper picks (many blocks per SM at P = 9155), all of a batch's
// q bytes and scales loaded into registers before the ordered fold, and the
// eq. 4 weights built by one warp from registers while those loads are in
// flight (see the comment above the kernel). Each position's scale column
// is read once from cols; a warp's 32 positions share one or two scales, a
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

constexpr int THREADS = 256;
constexpr int ITEMS = 2;
constexpr int TILE = THREADS * ITEMS;
constexpr float EQ4_EPS = 1e-12f;

__device__ __forceinline__ float clamp_min(float x, float lo) {
  // NaN propagates, as torch.clamp_min / jnp.maximum do
  return x < lo ? lo : x;
}

// Stages one agent's eq. 4 weights in w_s (m floats; r_s is m more floats
// of scratch) and, from block 0, writes its Σw: every thread loads a share
// of the metadata; only the sums are sequential, and they read shared memory.
__device__ void stage_eq4_weights(const float* __restrict__ T,
                                  const float* __restrict__ R,
                                  const uint8_t* __restrict__ valid,
                                  float* w_s, float* r_s, float* sums,
                                  float* __restrict__ wsum, int agent,
                                  int m) {
  const long long meta = (long long)agent * m;
  for (int j = threadIdx.x; j < m; j += THREADS) {
    const float v = valid[meta + j] ? 1.f : 0.f;
    w_s[j] = __fmul_rn(T[meta + j], v);
    r_s[j] = __fmul_rn(R[meta + j], v);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float st = 0.f, sr = 0.f;
    for (int j = 0; j < m; ++j) {
      st = __fadd_rn(st, w_s[j]);
      sr = __fadd_rn(sr, r_s[j]);
    }
    sums[0] = clamp_min(st, EQ4_EPS);
    sums[1] = clamp_min(sr, EQ4_EPS);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < m; j += THREADS) {
    const float t_hat = __fdiv_rn(w_s[j], sums[0]);
    const float r_hat = __fdiv_rn(r_s[j], sums[1]);
    w_s[j] = __fmul_rn(0.5f, __fadd_rn(t_hat, r_hat));
  }
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x == 0) {  // Σw once per agent
    float s = 0.f;
    for (int j = 0; j < m; ++j) s = __fadd_rn(s, w_s[j]);
    wsum[agent] = s;
  }
}

template <bool FUSED>
__global__ void __launch_bounds__(THREADS)
wavg_kernel(const float* __restrict__ G, const float* __restrict__ T,
            const float* __restrict__ R, const uint8_t* __restrict__ valid,
            const float* __restrict__ w_in, float* __restrict__ out,
            float* __restrict__ wsum, int m, long long P) {
  // this agent's m weights; the fused path also stages the masked R here
  extern __shared__ float smem[];
  float* w_s = smem;
  __shared__ float sums[2];
  const int agent = blockIdx.y;
  const long long meta = (long long)agent * m;

  if (FUSED) {
    stage_eq4_weights(T, R, valid, w_s, smem + m, sums, wsum, agent, m);
  } else {
    for (int j = threadIdx.x; j < m; j += THREADS) w_s[j] = w_in[meta + j];
    __syncthreads();
  }

  const float* g = G + meta * P;
  float* o = out + (long long)agent * P;
  for (long long base = (long long)blockIdx.x * TILE; base < P;
       base += (long long)gridDim.x * TILE) {
    float acc[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) acc[i] = 0.f;
    // unrolled so that loads of several pieces are in flight at once;
    // the adds still run j = 0, 1, 2, ... per element
#pragma unroll 8
    for (int j = 0; j < m; ++j) {
      const float wj = w_s[j];
      const float* row = g + (long long)j * P;
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const long long p = base + threadIdx.x + (long long)i * THREADS;
        if (p < P) acc[i] = __fadd_rn(acc[i], __fmul_rn(wj, __ldg(row + p)));
      }
    }
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const long long p = base + threadIdx.x + (long long)i * THREADS;
      if (p < P) o[p] = acc[i];
    }
  }
}

// ---------------------------------------------------------------------
// The int8 share step: many small blocks, loads issued before the fold.
//
// Block b of agent a takes the ITEMS · 64 positions from b · ITEMS · 64 on,
// thread t the positions t, t + 64, ... (so each load instruction of a warp
// reads 32 neighbouring bytes). The wrapper (ops.py::wavg_q_geometry) picks
// BATCH, the pieces held in registers at a time (8, 16 or 32: the least
// that covers m, 32 past that), and ITEMS (32 / BATCH where the grid still
// holds 4 blocks per SM, else 1): (8, 32, 9155) gives 1,152 blocks, one
// position per thread, and the big plane (16, 8, 2^20 + 37) 65,552 blocks,
// four positions per thread. The launch bounds keep 9 blocks resident per
// SM (1,188 on the card: the main path's 1,152 in one wave), which leaves
// 96 registers a thread (18 warps, 5 on each of the SM's four 16,384-
// register schedulers). A batch's q bytes and scales in flight take 64 of
// them per position; ptxas spills a few bytes to L1 in the instances that
// hold 32 values per position (PERF.md §6 has the counts).
// Each thread first issues its scale-column loads and the q bytes of the
// first BATCH pieces; warp 0 issues the first 32 pieces' metadata loads;
// then each thread issues its BATCH scale loads per position (which wait on
// the column). Only then does warp 0 build the eq. 4 weights in registers
// (sums folded from shuffled registers, in order) and publish them in
// shared memory; after one barrier every thread folds its BATCH pieces in j
// order into one accumulator per position. Pieces past the first BATCH
// follow in further batches (m up to MAX_PIECES). A thread past P loads
// nothing but still reaches the barrier.

constexpr int Q_THREADS = 64;         // threads per block
constexpr int Q_MIN_BLOCKS = 9;       // resident per SM: ≤ 96 registers
constexpr unsigned FULL = 0xffffffffu;

// The eq. 4 weights of one agent's m pieces into w_s (shared), and its Σw
// into wsum[agent] when `sum_w` is set, by the 32 lanes of one warp. The op
// order is eq4_weights': mask (T·v, R·v), sums left to right from 0, clamp
// at 1e-12, divide, ½(t̂ + r̂); Σw left to right from 0. Lane k holds piece
// base + k of each round of 32; the sums take the lanes' values through
// shuffles, which do not depend on the running sum, so only the adds are a
// chain. (t0, r0) are round 0's masked values, loaded by the caller early.
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
#pragma unroll 8
    for (int k = 0; k < count; ++k) {
      st = __fadd_rn(st, __shfl_sync(FULL, t, k));
      sr = __fadd_rn(sr, __shfl_sync(FULL, r, k));
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

dim3 grid_for(int n, long long P) {
  const long long tiles = (P + TILE - 1) / TILE;
  return dim3((unsigned)(tiles < 2147483647LL ? tiles : 2147483647LL),
              (unsigned)n);
}

}  // namespace

// The entry points make `device` current (this library links its own CUDA
// runtime, whose current device is not PyTorch's), launch on `stream`, do
// not synchronise and return the launch status for the caller to check.
extern "C" int ddal_fused_wavg(const float* G, const float* T, const float* R,
                               const uint8_t* valid, float* out, float* wsum,
                               int n, int m, long long P, int device,
                               cudaStream_t stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  wavg_kernel<true><<<grid_for(n, P), THREADS, 2 * m * sizeof(float),
                      stream>>>(
      G, T, R, valid, nullptr, out, wsum, m, P);
  return (int)cudaGetLastError();
}

extern "C" int ddal_wavg(const float* G, const float* w, float* out, int n,
                         int m, long long P, int device, cudaStream_t stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  wavg_kernel<false><<<grid_for(n, P), THREADS, m * sizeof(float), stream>>>(
      G, nullptr, nullptr, nullptr, w, out, nullptr, m, P);
  return (int)cudaGetLastError();
}

// The int8 entry takes its launch geometry from the caller
// (ops.py::wavg_q_geometry): `items` positions per thread and `batch` pieces
// per batch (one of the instances below), and `blocks` = ⌈P / (Q_THREADS ·
// items)⌉ blocks per agent.
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

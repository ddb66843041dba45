// DDAL eq. 4 share step for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/ddal_wavg/kernel.py:
//   * fused_wavg_flat (:164, body _fused_wavg_kernel :101) — ddal_fused_wavg:
//     rebuilds w = ½(T̂ + R̂) from the raw (T, R, valid) metadata inside the
//     kernel and writes (ḡ, Σw);
//   * wavg_flat (:58, body _wavg_kernel :48) — ddal_wavg: the same
//     contraction with the weights computed outside;
//   * fused_wavg_q_flat (:185, body _fused_wavg_q_kernel :123) —
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
// over the HBM rate. The design reads G once, in coalesced rows (neighbouring
// threads on neighbouring elements of one piece), keeps ITEMS fp32
// accumulators per thread in registers for the whole j loop (unrolled, so
// several pieces' loads are in flight) and writes ḡ once. One launch covers
// every agent: grid (⌈P / TILE⌉, n), and a TILE of 512 gives the quickstart's
// small planes (P = 9155) 18 blocks per agent. P is the A2C parameter count
// (odd), so rows are not 16-byte aligned: loads stay scalar and the ragged
// end is masked, with no padding copy. The int8 kernel reads each position's
// scale column once from cols and each piece's scale through the read-only
// cache: a warp's 32 positions share one or two scales, a broadcast.
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

__global__ void __launch_bounds__(THREADS)
wavg_q_kernel(const int8_t* __restrict__ Q, const float* __restrict__ scale,
              const int* __restrict__ cols, const float* __restrict__ T,
              const float* __restrict__ R, const uint8_t* __restrict__ valid,
              float* __restrict__ out, float* __restrict__ wsum, int m,
              long long P, int nb) {
  extern __shared__ float smem[];
  float* w_s = smem;
  __shared__ float sums[2];
  const int agent = blockIdx.y;
  const long long meta = (long long)agent * m;
  stage_eq4_weights(T, R, valid, w_s, smem + m, sums, wsum, agent, m);

  const int8_t* q = Q + meta * P;
  const float* s = scale + meta * nb;
  float* o = out + (long long)agent * P;
  for (long long base = (long long)blockIdx.x * TILE; base < P;
       base += (long long)gridDim.x * TILE) {
    float acc[ITEMS];
    int col[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const long long p = base + threadIdx.x + (long long)i * THREADS;
      acc[i] = 0.f;
      col[i] = p < P ? __ldg(cols + p) : 0;   // once, for all m pieces
    }
#pragma unroll 8
    for (int j = 0; j < m; ++j) {
      const float wj = w_s[j];
      const int8_t* row = q + (long long)j * P;
      const float* srow = s + (long long)j * nb;
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const long long p = base + threadIdx.x + (long long)i * THREADS;
        if (p < P) {
          const float x = __fmul_rn((float)__ldg(row + p),
                                    __ldg(srow + col[i]));
          acc[i] = __fadd_rn(acc[i], __fmul_rn(wj, x));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const long long p = base + threadIdx.x + (long long)i * THREADS;
      if (p < P) o[p] = acc[i];
    }
  }
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

extern "C" int ddal_fused_wavg_q(const int8_t* Q, const float* scale,
                                 const int* cols, const float* T,
                                 const float* R, const uint8_t* valid,
                                 float* out, float* wsum, int n, int m,
                                 long long P, int nb, int device,
                                 cudaStream_t stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  wavg_q_kernel<<<grid_for(n, P), THREADS, 2 * m * sizeof(float), stream>>>(
      Q, scale, cols, T, R, valid, out, wsum, m, P, nb);
  return (int)cudaGetLastError();
}

extern "C" const char* ddal_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

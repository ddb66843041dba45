// Causal GQA flash attention (online softmax) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py:93
// flash_attention_bhsd (body _fa_kernel :33). For every batch b, query head h
// and query row i < S, with kv head kh = h / (H / K):
//
//   s_j  = (q_i . k_j) * scale                        in fp32
//   s_j  = -1e30 where not (j <= i and j < S and (no window or i - j < W))
//   o_i  = sum_j exp(s_j - m) v_j / max(sum_j exp(s_j - m), 1e-30)
//
// computed tile by tile with the reference's online-softmax recurrence:
// m_new = max(m, max_j s_j), alpha = exp(m - m_new), p = exp(s - m_new),
// l = l * alpha + sum p, acc = acc * alpha + p v; m starts at -1e30, l and acc
// at 0. The finite -1e30 is kept on purpose: a tile that is fully masked for a
// row (a window's edge) then leaves finite junk that alpha = exp(-1e30 - m)
// = 0 wipes when the row's first real tile arrives, where a true -inf would
// give exp(-inf + inf) = NaN. The mask is by index, as in the reference kernel,
// not by position.
//
// Layout: the model's own, so the caller makes no copy and no GQA repeat.
//   q (B, S, H, D), k and v (B, S, K, D): fp32 or bf16 (the three alike), any
//   strides over b, s and the head with the head dim contiguous;
//   o (B, S, H, D) contiguous, in q's dtype.
// D in {16, 32, 64, 128}; any S (the ragged last tile is masked here, never
// padded by a copy); H a multiple of K.
//
// Bound. The causal half holds S(S+1)/2 (i, j) pairs per (b, h), each with a
// D-long dot product for the score and a D-long update of the output: at the
// scoring path's (B, H, S, D) = (2, 24, 4096, 128) that is 103 GFLOP for q.k^T
// and 103 GFLOP for p.v against 134 MB of q, k, v and o in bf16. Operations
// bound it: with bf16 inputs q.k^T could run at the bf16 tensor-core rate
// (bf16 products are exact in fp32), but p is fp32 as in the reference, so p.v
// runs at the fp32 rate: 0.10 + 1.54 = 1.64 ms on an H100 SXM.
//
// Design. The TPU kernel walks a sequential (B, H, nQ, nK) grid with (128,
// 128) VMEM tiles and carries m, l and acc across the innermost grid axis in
// scratch. Hopper blocks run in parallel and in no order, so the walk over the
// key tiles is a loop inside the block:
//   * block (query tile, h, b) owns BQ = 64 query rows of one head and keeps
//     their m, l and the 64 x D fp32 accumulator in registers; 256 threads as
//     16 x 16, each with 4 rows x 4 key columns of a score tile and 4 rows x
//     D/16 output columns;
//   * q is staged once, transposed, in shared memory; per key tile of BK = 64
//     it stages k transposed, forms the 64 x 64 scores on the CUDA cores in
//     fp32 (one 16-byte load of q, a broadcast, and one of k per 16 FMAs),
//     masks them, runs the online softmax with the row max and sum reduced
//     over the 16 threads of a row by warp shuffles, writes p transposed and
//     stages v over the k space, then adds p v into the accumulator;
//   * it visits only the key tiles that can hold an unmasked entry (j0 <= the
//     tile's last row; with a window, j0 + BK - 1 > i0 - W), so it does the
//     causal half's work (2080 of 4096 tiles at S = 4096) and O(S W) with a
//     window; the tiles with the most keys are scheduled first;
//   * bf16 inputs are widened to fp32 as they are staged, so both dtypes do
//     fp32 arithmetic on the values the plain version reads.
// Shared memory: 87,040 B at D = 128 (q^T, k^T / v, p^T), two blocks per SM.
// No atomics and a fixed summation order: two launches give the same bits.
// Tensor cores (mma / wgmma on bf16 q.k^T) and TMA staging are later steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // key columns per tile
constexpr int LD = BQ + 4;     // stride of the transposed tiles: 16-byte rows
constexpr int THREADS = 256;   // 16 x 16 threads
constexpr float NEG_INF = -1e30f;

static_assert(BQ == BK, "the diagonal tile is the block's own rows");

// Output columns of one thread: N = D / 16, loaded VW at a time from shared
// memory, in G groups; column (g, c) is g * 16 * VW + tx * VW + c.
template <int D>
struct Cols {
  static constexpr int N = D / 16;
  static constexpr int VW = N < 4 ? N : 4;
  static constexpr int G = N / VW;
  static constexpr int LDV = D + 4;            // v row stride
  static constexpr int KV = (D * LD > BK * LDV) ? D * LD : BK * LDV;
  static constexpr int FLOATS = D * LD + KV + BK * LD;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void narrow(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

template <int VW>
__device__ __forceinline__ void load_vec(const float* src, float* dst) {
  if constexpr (VW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(src);
    dst[0] = t.x; dst[1] = t.y; dst[2] = t.z; dst[3] = t.w;
  } else if constexpr (VW == 2) {
    const float2 t = *reinterpret_cast<const float2*>(src);
    dst[0] = t.x; dst[1] = t.y;
  } else {
    dst[0] = *src;
  }
}

// max / sum over the 16 threads of a row (lanes that differ in the low 4
// bits of the lane id: one half-warp)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int H,
                 int K, int window, float scale, long long qsb, long long qss,
                 long long qsh, long long ksb, long long kss, long long ksh,
                 long long vsb, long long vss, long long vsh) {
  using C = Cols<D>;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                 // q[i0 + r][d] at d * LD + r
  float* kv = smem + D * LD;        // k[j0 + c][d] at d * LD + c, then
                                    // v[j0 + jj][col] at jj * LDV + col
  float* pt = kv + C::KV;           // p[r][jj] at jj * LD + r

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int it = gridDim.x - 1 - blockIdx.x;   // the longest rows first
  const int hd = blockIdx.y, b = blockIdx.z;
  const int kh = hd / (H / K);
  const int i0 = it * BQ;
  const T* qb = q + b * qsb + hd * qsh;
  const T* kb = k + b * ksb + kh * ksh;
  const T* vb = v + b * vsb + kh * vsh;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D, i = i0 + r;
    qt[d * LD + r] = i < S ? widen(qb[i * qss + d]) : 0.f;
  }

  float m[4], l[4], acc[4][C::N];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < C::N; ++c) acc[r][c] = 0.f;
  }

  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * BK;
    // entirely left of every row's window: skipped by the whole block
    if (window > 0 && j0 + BK - 1 <= i0 - window) continue;
    __syncthreads();             // q staged; the last tile's reads are done
    for (int e = tid; e < BK * D; e += THREADS) {
      const int c = e / D, d = e % D, j = j0 + c;
      kv[d * LD + c] = j < S ? widen(kb[j * kss + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * LD + ty * 4);
      const float4 bk = *reinterpret_cast<const float4*>(kv + d * LD + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(av[r], bv[c], s[r][c]);
    }

    // scale, mask, and the online-softmax step of each row
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty * 4 + r;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + tx * 4 + c;
        const bool ok = j <= i && j < S && (window <= 0 || i - j < window);
        s[r][c] = ok ? s[r][c] * scale : NEG_INF;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], row_max(mx));
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = expf(s[r][c] - m_new);
        sum += s[r][c];
      }
      l[r] = l[r] * alpha + row_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < C::N; ++c) acc[r][c] *= alpha;
    }

    __syncthreads();             // every read of k is done: p^T and v
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(pt + (tx * 4 + c) * LD + ty * 4) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    for (int e = tid; e < BK * D; e += THREADS) {
      const int jj = e / D, col = e % D, j = j0 + jj;
      kv[jj * C::LDV + col] = j < S ? widen(vb[j * vss + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < BK; ++jj) {
      const float4 a = *reinterpret_cast<const float4*>(pt + jj * LD + ty * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int g = 0; g < C::G; ++g) {
        float bv[C::VW];
        load_vec<C::VW>(kv + jj * C::LDV + g * 16 * C::VW + tx * C::VW, bv);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < C::VW; ++c)
            acc[r][g * C::VW + c] = fmaf(av[r], bv[c], acc[r][g * C::VW + c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    if (i >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = o + ((static_cast<long long>(b) * S + i) * H + hd) * D;
#pragma unroll
    for (int g = 0; g < C::G; ++g)
#pragma unroll
      for (int c = 0; c < C::VW; ++c)
        narrow(orow + g * 16 * C::VW + tx * C::VW + c,
               acc[r][g * C::VW + c] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int K, int window, float scale,
                   const long long* st, cudaStream_t stream) {
  const int bytes = Cols<D>::FLOATS * static_cast<int>(sizeof(float));
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((unsigned)((S + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
  flash_fwd_kernel<T, D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, K, window, scale,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int B, int S, int H, int K, int D, int window,
                     float scale, const long long* st, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, H, K, window, scale, st,
                                  stream);
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, K, window, scale, st,
                                  stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, K, window, scale, st,
                                  stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, K, window, scale,
                                    st, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Makes `device` current (this library links its own CUDA runtime, whose
// current device is not PyTorch's), launches on `stream`, does not
// synchronise and returns the launch status. dtype: 0 = fp32, 1 = bf16 for q,
// k, v and o. window <= 0: no window. Strides are in elements, over (b, s,
// head) of q, k and v in that order; the head dim is contiguous.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int S,
                                   int H, int K, int D, int window,
                                   float scale, long long qsb, long long qss,
                                   long long qsh, long long ksb,
                                   long long kss, long long ksh,
                                   long long vsb, long long vss,
                                   long long vsh, int dtype, int device,
                                   cudaStream_t stream) {
  if (B < 1 || B > 65535 || S < 1 || H < 1 || H > 65535 || K < 1 ||
      H % K != 0)
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  if (dtype == 0)
    return (int)launch_d<float>(q, k, v, o, B, S, H, K, D, window, scale, st,
                                stream);
  if (dtype == 1)
    return (int)launch_d<__nv_bfloat16>(q, k, v, o, B, S, H, K, D, window,
                                        scale, st, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

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
//   strides over b, s and the head with the head dim contiguous (bf16: the
//   pointers and those strides 16-byte aligned, for cp.async);
//   o (B, S, H, D) contiguous, in q's dtype.
// D in {16, 32, 64, 112, 128}; any S (the ragged last tile is masked here, never
// padded by a copy); H a multiple of K.
//
// Two kernels, one per input dtype; nothing falls back from one to the other.
//
// bf16 inputs: flash_fwd_bf16_mma_kernel, on the tensor cores.
//   Bound. The causal half holds S(S+1)/2 (i, j) pairs per (b, h), each with a
//   D-long dot product for the score and a D-long update of the output: at the
//   scoring path's (B, H, S, D) = (2, 24, 4096, 128) that is 103.1 GFLOP per
//   product against 134 MB of q, k, v and o. q.k^T is one bf16 product (bf16
//   products are exact in fp32). p is fp32 in the reference, and one bf16
//   rounding of p moves ~9 % of the outputs by more than one bf16 unit, so p.v
//   takes two bf16 products, p_hi.v + p_lo.v with p_hi = bf16(p) and p_lo =
//   bf16(p - p_hi), which keeps every output within one unit (or one TF32
//   product at half the rate: the same time). Operations bound it:
//   3 x 103.1 GFLOP at 989 TFLOP/s = 0.313 ms on an H100 SXM; the bytes take
//   0.040 ms.
//   Design (FlashAttention-2's shape with mma.sync):
//   * block (query tile, h, b) owns BQ = 128 query rows of one head, 8 warps of
//     16 rows; the longest query tiles are scheduled first;
//   * q.k^T: mma.sync m16n8k16 bf16 -> fp32; the warp's q fragments are loaded
//     once with ldmatrix and stay in registers, k fragments come from shared
//     memory by ldmatrix;
//   * the softmax runs on the score fragments in registers: the mask by index
//     on the fragment coordinates, row max over the 4 lanes of a quad by
//     shuffles, alpha and p in fp32 (expf), l from the fp32 p (a per-thread
//     partial, summed over the quad at the end);
//   * p never leaves registers: the fp32 C fragment of the score MMA is the A
//     fragment of the next m16n8k16 once packed to bf16, split into hi and lo,
//     two MMAs per fragment into the same fp32 accumulator; v fragments come
//     by ldmatrix.trans;
//   * k and v tiles of BK = 64 keys in a 2-stage shared-memory ring filled by
//     16-byte cp.async.cg copies, tile j + 1 in flight while tile j computes;
//     rows at or past S are zero-filled by the copy (src-size 0); rows are
//     padded by 16 bytes, so each 8-row ldmatrix phase hits 32 distinct banks;
//   * only the key tiles that can hold an unmasked entry are visited (1056 of
//     the 128 x 64 tiles per (b, h) at S = 4096, 3 % above the kept pairs;
//     O(S W) with a window), a warp skips a visited tile that is wholly masked
//     for its 16 rows, and the mask is applied only on tiles that cut it.
//   Shared memory: 104,448 B at D = 128 (q, two k / v stages), 92,160 B at
//   D = 112 (rows of 120 bf16 = 240 B: eight rows start 112 B apart mod
//   128 B, in eight distinct 16-byte bank groups, so ldmatrix stays
//   conflict-free; KS = 7 k-steps, 14 output n-tiles, 7 ldmatrix pairs).
//
// fp32 inputs: flash_fwd_fp32_kernel, on the CUDA cores in IEEE fp32 (the
//   tensor cores would round to TF32 and leave the reference's rtol = atol =
//   2e-5). Bound: both products at the fp32 rate, 2 x 103.1 GFLOP at 67 TFLOP/s
//   = 3.08 ms at the scoring path's shape.
//   Design: block (query tile, h, b) owns BQ = 64 query rows and keeps their
//   m, l and the 64 x D accumulator in registers, 256 threads as 16 x 16, each
//   with 4 rows x 4 key columns of a score tile and 4 rows x D/16 output
//   columns; q is staged once, transposed, in shared memory; per key tile of
//   64 it stages k transposed, forms the scores, masks them, runs the online
//   softmax (row max and sum over the 16 threads of a row by shuffles), writes
//   p transposed and stages v over the k space, then adds p v; the same tile
//   visits as above on 64 x 64 tiles. Shared memory: 87,040 B at D = 128.
//
// Both: no atomics and a fixed summation order, so two launches give the same
// bits. wgmma with TMA and warp specialisation are later steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;

// first and one-past-last key tile of width bk that a query tile of rows
// [i0, i0 + bq) can see: j0 <= the tile's last real row and, with a window,
// j0 + bk - 1 > i0 - window
__device__ __forceinline__ int2 key_tiles(int i0, int bq, int bk, int S,
                                          int window) {
  const int last = min(i0 + bq, S) - 1;
  const int lo = window > 0 ? max(0, i0 - window + 1) : 0;
  return make_int2(lo / bk, last / bk + 1);
}

// ----------------------------------------------------------------------------
// fp32: CUDA cores
// ----------------------------------------------------------------------------

namespace fp32 {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // key columns per tile
constexpr int LD = BQ + 4;     // stride of the transposed tiles: 16-byte rows

static_assert(BQ == BK, "the diagonal tile is the block's own rows");

// Output columns of one thread: N = D / 16, loaded VW at a time from shared
// memory, in G groups; column (g, c) is g * 16 * VW + tx * VW + c. VW is the
// widest of 4, 2 and 1 that divides N, so the G * VW columns are all N (at
// D = 112, N = 7: VW = 1, G = 7).
template <int D>
struct Cols {
  static constexpr int N = D / 16;
  static constexpr int VW = N % 4 == 0 ? 4 : (N % 2 == 0 ? 2 : 1);
  static constexpr int G = N / VW;
  static_assert(D % 16 == 0 && N % VW == 0 && G * VW == N,
                "every output column of a thread in some group");
  static constexpr int LDV = D + 4;            // v row stride
  static constexpr int KV = (D * LD > BK * LDV) ? D * LD : BK * LDV;
  static constexpr int BYTES = (D * LD + KV + BK * LD) * 4;
};

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

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      int S, int H, int K, int window, float scale,
                      long long qsb, long long qss, long long qsh,
                      long long ksb, long long kss, long long ksh,
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
  const float* qb = q + b * qsb + hd * qsh;
  const float* kb = k + b * ksb + kh * ksh;
  const float* vb = v + b * vsb + kh * vsh;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D, i = i0 + r;
    qt[d * LD + r] = i < S ? qb[i * qss + d] : 0.f;
  }

  float m[4], l[4], acc[4][C::N];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < C::N; ++c) acc[r][c] = 0.f;
  }

  const int2 tiles = key_tiles(i0, BQ, BK, S, window);
  for (int jt = tiles.x; jt < tiles.y; ++jt) {
    const int j0 = jt * BK;
    __syncthreads();             // q staged; the last tile's reads are done
    for (int e = tid; e < BK * D; e += THREADS) {
      const int c = e / D, d = e % D, j = j0 + c;
      kv[d * LD + c] = j < S ? kb[j * kss + d] : 0.f;
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
      kv[jj * C::LDV + col] = j < S ? vb[j * vss + col] : 0.f;
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
    float* orow = o + ((static_cast<long long>(b) * S + i) * H + hd) * D;
#pragma unroll
    for (int g = 0; g < C::G; ++g)
#pragma unroll
      for (int c = 0; c < C::VW; ++c)
        orow[g * 16 * C::VW + tx * C::VW + c] = acc[r][g * C::VW + c] / denom;
  }
}

}  // namespace fp32

// ----------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16)
// ----------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int BQ = 128;        // query rows per block: 8 warps x 16
constexpr int BK = 64;         // keys per tile
constexpr int WARPS = THREADS / 32;
static_assert(WARPS * 16 == BQ, "one m16 row tile per warp");

template <int D>
struct Smem {
  static constexpr int LD = D + 8;   // row stride in bf16: rows 16 B apart
                                     // mod 128 B, so ldmatrix is conflict-free
  static constexpr int Q = BQ * LD;
  static constexpr int KV = BK * LD;
  static constexpr int BYTES = (Q + 4 * KV) * 2;   // q, 2 stages of k and v
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x, y) -> hi = bf16(x, y), lo = bf16((x, y) - hi); x in the low half
__device__ __forceinline__ void split(float x, float y, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// rows [r0, r0 + rows) of a (S, D) bf16 matrix with row stride ss into
// shared memory at stride LD; rows at or past S are zero-filled
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long ss, int r0, int rows,
                                          int S, int tid) {
  constexpr int CPR = D / 8;                 // 16-byte chunks per row
  for (int c = tid; c < rows * CPR; c += THREADS) {
    const int r = c / CPR, ch = c % CPR, row = r0 + r;
    const bool ok = row < S;
    cp_async16(smem_addr(dst + r * Smem<D>::LD + ch * 8),
               src + (ok ? row * ss : 0) + ch * 8, ok);
  }
}

// registers: the q fragments, the 16 x D accumulator and the 16 x 64 scores
// of a warp stay in registers; at D >= 64 they need more than the 128 a
// thread may have at 2 blocks per SM (D = 64 spills 12 bytes there), so 1
template <int D>
__global__ void __launch_bounds__(THREADS, (D >= 64 ? 1 : 2))
flash_fwd_bf16_mma_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          int S, int H, int K, int window, float scale,
                          long long qsb, long long qss, long long qsh,
                          long long ksb, long long kss, long long ksh,
                          long long vsb, long long vss, long long vsh) {
  using L = Smem<D>;
  constexpr int KS = D / 16;     // k-steps of the score MMA
  constexpr int NS = BK / 8;     // 8-key n-tiles of a score tile
  constexpr int ND = D / 8;      // 8-wide n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* skv = sq + L::Q;         // stage t: k at (2t) * KV, v at (2t + 1) * KV

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;    // fragment row / column pair
  const int it = gridDim.x - 1 - blockIdx.x;   // the longest rows first
  const int hd = blockIdx.y, b = blockIdx.z;
  const int kh = hd / (H / K);
  const int i0 = it * BQ;
  const int w0 = i0 + warp * 16;               // this warp's first row
  const int r0 = w0 + g, r1 = r0 + 8;          // this thread's two rows
  const bf16* qb = q + b * qsb + hd * qsh;
  const bf16* kb = k + b * ksb + kh * ksh;
  const bf16* vb = v + b * vsb + kh * vsh;

  const int2 tiles = key_tiles(i0, BQ, BK, S, window);
  load_rows<D>(sq, qb, qss, i0, BQ, S, tid);
  load_rows<D>(skv, kb, kss, tiles.x * BK, BK, S, tid);
  load_rows<D>(skv + L::KV, vb, vss, tiles.x * BK, BK, S, tid);
  cp_async_commit();

  uint32_t qf[KS][4];
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int jt = tiles.x; jt < tiles.y; ++jt) {
    const int stage = (jt - tiles.x) & 1;
    cp_async_wait_all();
    __syncthreads();             // tile jt landed; tile jt - 1 is read
    if (jt == tiles.x) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldmatrix_x4(qf[ks], smem_addr(sq + (warp * 16 + (lane & 15)) * L::LD
                                      + ks * 16 + (lane >> 4) * 8));
    }
    if (jt + 1 < tiles.y) {
      bf16* nk = skv + 2 * (stage ^ 1) * L::KV;
      load_rows<D>(nk, kb, kss, (jt + 1) * BK, BK, S, tid);
      load_rows<D>(nk + L::KV, vb, vss, (jt + 1) * BK, BK, S, tid);
    }
    cp_async_commit();

    const int j0 = jt * BK;
    // wholly masked for this warp's rows: the warp skips the tile
    if (j0 > w0 + 15 || (window > 0 && j0 + BK - 1 <= w0 - window)) continue;
    const bf16* sk = skv + 2 * stage * L::KV;
    const bf16* sv = sk + L::KV;

    // s = q k^T: n-tile pairs (16 keys) by ldmatrix.x4, k-steps of 16 dims
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, smem_addr(sk + (np * 16 + (lane & 7) + (lane >> 4) * 8)
                                  * L::LD + ks * 16 + ((lane >> 3) & 1) * 8));
        mma(s[2 * np], qf[ks], kf[0], kf[1]);
        mma(s[2 * np + 1], qf[ks], kf[2], kf[3]);
      }
    }

    // scale and mask (only on tiles that cut the mask), online softmax;
    // element e of n-tile n is row (e < 2 ? r0 : r1), key j0 + 8n + 2t4 + e%2
    const bool edge = j0 + BK - 1 > i0 || j0 + BK > S ||
                      (window > 0 && j0 <= i0 + BQ - 1 - window);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (edge) {
          const int i = e < 2 ? r0 : r1, j = j0 + n * 8 + 2 * t4 + (e & 1);
          const bool ok = j <= i && j < S && (window <= 0 || i - j < window);
          x = ok ? x : NEG_INF;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        sum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // acc += p v: the score C fragments of keys 16kk .. 16kk + 15 are the A
    // fragment of one m16n8k16, as hi and lo bf16 halves
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      split(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      split(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      split(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, smem_addr(
            sv + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * L::LD
            + dp * 16 + (lane >> 4) * 8));
        mma(acc[2 * dp], hi, vf[0], vf[1]);
        mma(acc[2 * dp], lo, vf[0], vf[1]);
        mma(acc[2 * dp + 1], hi, vf[2], vf[3]);
        mma(acc[2 * dp + 1], lo, vf[2], vf[3]);
      }
    }
  }

  // l over the quad; o = acc / max(l, 1e-30) in bf16, row by row
  const float denom[2] = {fmaxf(quad_sum(l[0]), 1e-30f),
                          fmaxf(quad_sum(l[1]), 1e-30f)};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r ? r1 : r0;
    if (i >= S) continue;
    bf16* orow = o + ((static_cast<long long>(b) * S + i) * H + hd) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[n][2 * r] / denom[r],
                                acc[n][2 * r + 1] / denom[r]);
  }
}

}  // namespace tc

// The kernel instance, its dynamic shared memory and its block for one dtype
// (0 = fp32, 1 = bf16) and head dim; false for anything else.
struct Instance {
  const void* fn;
  int bytes;
  int bq;
};

template <int D>
Instance instance_d(int dtype) {
  if (dtype == 0)
    return {reinterpret_cast<const void*>(&fp32::flash_fwd_fp32_kernel<D>),
            fp32::Cols<D>::BYTES, fp32::BQ};
  return {reinterpret_cast<const void*>(&tc::flash_fwd_bf16_mma_kernel<D>),
          tc::Smem<D>::BYTES, tc::BQ};
}

bool instance(int dtype, int D, Instance* out) {
  if (dtype != 0 && dtype != 1) return false;
  switch (D) {
    case 16: *out = instance_d<16>(dtype); return true;
    case 32: *out = instance_d<32>(dtype); return true;
    case 64: *out = instance_d<64>(dtype); return true;
    case 112: *out = instance_d<112>(dtype); return true;
    case 128: *out = instance_d<128>(dtype); return true;
    default: return false;
  }
}

}  // namespace

// Makes `device` current (this library links its own CUDA runtime, whose
// current device is not PyTorch's), launches on `stream`, does not
// synchronise and returns the launch status. dtype: 0 = fp32 (CUDA cores),
// 1 = bf16 (tensor cores) for q, k, v and o. window <= 0: no window. Strides
// are in elements, over (b, s, head) of q, k and v in that order; the head
// dim is contiguous. bf16 needs 16-byte aligned pointers and strides.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int S,
                                   int H, int K, int D, int window,
                                   float scale, long long qsb, long long qss,
                                   long long qsh, long long ksb,
                                   long long kss, long long ksh,
                                   long long vsb, long long vss,
                                   long long vsh, int dtype, int device,
                                   cudaStream_t stream) {
  Instance inst;
  if (B < 1 || B > 65535 || S < 1 || H < 1 || H > 65535 || K < 1 ||
      H % K != 0 || !instance(dtype, D, &inst))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
    for (long long s : st)
      if (s % 8) return (int)cudaErrorMisalignedAddress;
    for (const void* p : {q, k, v})
      if (reinterpret_cast<uintptr_t>(p) % 16)
        return (int)cudaErrorMisalignedAddress;
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const cudaError_t attr = cudaFuncSetAttribute(
      inst.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, inst.bytes);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)((S + inst.bq - 1) / inst.bq), (unsigned)H,
                  (unsigned)B);
  void* args[] = {&q,   &k,   &v,   &o,   &S,   &H,   &K,   &window,
                  &scale, &qsb, &qss, &qsh, &ksb, &kss, &ksh, &vsb,
                  &vss, &vsh};
  const cudaError_t launch = cudaLaunchKernel(inst.fn, grid, dim3(THREADS),
                                              args, inst.bytes, stream);
  if (launch != cudaSuccess) return (int)launch;
  return (int)cudaGetLastError();
}

// Blocks of the kernel instance that fit on one SM at once, into *blocks.
extern "C" int flash_attention_blocks_per_sm(int dtype, int D, int device,
                                             int* blocks) {
  Instance inst;
  if (!instance(dtype, D, &inst)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        inst.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, inst.bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, inst.fn,
                                                        THREADS, inst.bytes);
  return (int)err;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Mamba2 SSD intra-chunk dual form for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py:48
// ssd_intra_chunk_bchl (body _ssd_kernel :25): for every chunk of l steps and
// every head,
//
//   y[i, :] = sum_{j <= i} (C_i . B_j) * exp(cs_i - cs_j) * dt_j * x[j, :]
//
// with cs the inclusive cumsum of dt * A over the chunk (non-increasing, so
// every exp above has a non-positive argument).
//
// Layout: the model's own, so the caller makes no copy.
//   x   (bn, l, h, p)  fp32 or bf16     dt, cs (bn, l, h) fp32
//   B,C (bn, l, g, n)  as x; head k reads group k / (h / g)
//   out (bn, l, h, p)  fp32
// bn = batch * chunks. Any l, n and g dividing h; p <= 64. All contiguous.
// The launch geometry comes from the caller (ops.py::ssd_geometry) and is
// refused unless it covers every (chunk, row tile, head) exactly once.
//
// Two kernels, one per input dtype; nothing falls back from one to the other.
//
// bf16 inputs: tc::ssd_chunk_bf16_mma_kernel<HB>, on the tensor cores.
//   Bound. Over the l(l+1)/2 causal (i, j) pairs of a chunk: C_i . B_j is 2n
//   operations once per (chunk, group), since the heads of a group share B
//   and C; per (chunk, head) the decay and its products (3) and S . x_j. S is
//   fp32 in the reference, and one bf16 rounding of S lands ~120x outside the
//   1e-5 * sum|terms| gate, so S . x takes two bf16 products, S_hi . x +
//   S_lo . x with S_hi = bf16(S) and S_lo = bf16(S - S_hi) (a third term adds
//   nothing the gate sees). At the serving path's (bn, h, l, p, n, g) =
//   (8, 48, 256, 64, 128, 1) that is 3.3 GFLOP on the tensor cores, 4.0 us at
//   989 TFLOP/s, against 39.6 MB (25.2 MB of it the fp32 output), 11.8 us at
//   3.35 TB/s: bytes bound it.
//   Design:
//   * block (row-tile pair, head set, chunk) owns the 64-row tiles it and
//     tiles - 1 - it, so every block walks tiles + 1 column tiles and the
//     causal triangle needs no scheduling luck, and HB = 1, 2 or 3 heads
//     inside one group (HB divides h / g; one instance per HB);
//   * 4 warps of 16 rows. Per column tile, C . B^T (mma.sync m16n8k16 bf16
//     -> fp32; bf16 products are exact in fp32) is formed once, in the warp's
//     registers, and used by all HB heads before the next tile's: C . B^T is
//     computed once per (chunk, row tile, column tile, group) per block,
//     never per head;
//   * per head, S = (C . B^T) * exp(cs_i - cs_j) * dt_j is formed in
//     registers in the reference's op order, masked by a select on j <= i
//     (and i < l) on the tiles that cut the diagonal, split into S_hi + S_lo,
//     and used as the A fragments of the two S . x products (the accumulator
//     layout of one m16n8k16 is the A layout of the next); x fragments come
//     by ldmatrix.trans; the HB heads' y stay in registers for the whole row
//     tile and are written once, with streaming stores;
//   * one ring of 3 shared-memory stages, filled by 16-byte cp.async copies
//     (element by element where p or n is not a multiple of 8), carries for
//     each column tile its C and B chunks of 64 state dims, then the 64 x p
//     x tiles of the HB heads: the next tile's chunks load while the heads
//     compute. Rows and columns past l, n or p are zero-filled, so a padded
//     step contributes nothing;
//   * dt and cs of the block's heads are read once per window of 4 column
//     tiles, HB contiguous floats per step.
//   Registers: ~230 at HB = 3 (y of three heads, 96, and C . B^T, 32), two
//   blocks per SM; HB = 1, 2 fit three. Shared memory: 89,856 B at HB = 3.
//   What holds it (ssd_scan/trace.py on an H100 SXM): the ring never waits,
//   and a block with an SM to itself is only ~20 % faster than one beside
//   another, so each warp is bound by the latency of its own instruction
//   stream (the exps, their products and splits), with 8 warps per SM.
//
// fp32 inputs: fp32::ssd_chunk_fp32_kernel, on the CUDA cores in IEEE fp32 (the
//   tensor cores would round fp32 inputs to TF32). Bound: 0.0258 ms at the
//   serving path's shape, both products at 67 TFLOP/s.
//   Design: block (row tile, head, chunk) owns 64 rows i and all p <= 64
//   output columns, a 64 x 64 fp32 accumulator over 256 threads as 4 x 4
//   register tiles; per column tile j <= i it forms S = C_i B_j^T in registers
//   (32 state dims at a time through shared memory, transposed), applies the
//   decay and dt as a select on j <= i, writes S^T over the C / B staging
//   space, stages x_j, and adds S x_j.
//
// Both: no atomics and a fixed summation order, so two launches give the same
// bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

// ----------------------------------------------------------------------------
// fp32: CUDA cores
// ----------------------------------------------------------------------------

namespace fp32 {

constexpr int TI = 64;         // rows i per block
constexpr int TJ = 64;         // columns j per tile
constexpr int TP = 64;         // output columns: p <= TP
constexpr int NK = 32;         // state dims staged per step
constexpr int LD = TI + 4;     // shared row stride: 16-byte aligned rows
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each

static_assert(TI == TJ, "the diagonal tile is the block's own rows");
static_assert(TJ * LD == 2 * NK * LD, "S^T reuses the C / B staging space");

__global__ void __launch_bounds__(THREADS)
ssd_chunk_fp32_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ cs,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm, float* __restrict__ out,
                      int l, int h, int g, int p, int n) {
  __shared__ __align__(16) float stage[2 * NK * LD];  // C | B, then S^T
  __shared__ __align__(16) float xs[TJ * LD];
  __shared__ float cs_i[TI], cs_j[TJ], dt_j[TJ];
  float* c_s = stage;            // C[i0 + r][k0 + kk] at kk * LD + r
  float* b_s = stage + NK * LD;  // B[j0 + r][k0 + kk] at kk * LD + r
  float* s_t = stage;            // S[r][jj] at jj * LD + r

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int it = blockIdx.x, hd = blockIdx.y;
  const long long bc = blockIdx.z;
  const int grp = hd / (h / g);
  const int i0 = it * TI;
  // flat step index of step t of this chunk; rows of dt / cs, x and B / C
  const long long step0 = bc * l;

  if (tid < TI) {
    const int i = i0 + tid;
    cs_i[tid] = i < l ? cs[(step0 + i) * h + hd] : 0.f;
  }

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * TJ;
    __syncthreads();             // the previous tile's reads are done
    if (tid < TJ) {
      const int j = j0 + tid;
      cs_j[tid] = j < l ? cs[(step0 + j) * h + hd] : 0.f;
      dt_j[tid] = j < l ? dt[(step0 + j) * h + hd] : 0.f;
    }

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;

    for (int k0 = 0; k0 < n; k0 += NK) {
      __syncthreads();           // the previous step's reads are done
      for (int e = tid; e < TI * NK; e += THREADS) {
        const int r = e / NK, kk = e % NK, k = k0 + kk;
        const int i = i0 + r, j = j0 + r;
        c_s[kk * LD + r] =
            (i < l && k < n) ? Cm[((step0 + i) * g + grp) * n + k] : 0.f;
        b_s[kk * LD + r] =
            (j < l && k < n) ? Bm[((step0 + j) * g + grp) * n + k] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < NK; ++kk) {
        const float4 a =
            *reinterpret_cast<const float4*>(c_s + kk * LD + ty * 4);
        const float4 b =
            *reinterpret_cast<const float4*>(b_s + kk * LD + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = fmaf(av[r], bv[c], s[r][c]);
      }
    }

    // (S * L) * dt on j <= i, in the reference's op order; 0 elsewhere
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty * 4 + r;
      const float ci = cs_i[ty * 4 + r];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int jj = tx * 4 + c, j = j0 + jj;
        s[r][c] = (j <= i && j < l)
                      ? __fmul_rn(__fmul_rn(s[r][c], expf(ci - cs_j[jj])),
                                  dt_j[jj])
                      : 0.f;
      }
    }
    __syncthreads();             // every read of C / B is done: S^T over them
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(s_t + (tx * 4 + c) * LD + ty * 4) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    for (int e = tid; e < TJ * TP; e += THREADS) {
      const int r = e / TP, q = e % TP, j = j0 + r;
      xs[r * LD + q] = (j < l && q < p) ? x[((step0 + j) * h + hd) * p + q]
                                        : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int jj = 0; jj < TJ; ++jj) {
      const float4 a = *reinterpret_cast<const float4*>(s_t + jj * LD + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(xs + jj * LD + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    if (i >= l) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int q = tx * 4 + c;
      if (q < p) out[((step0 + i) * h + hd) * p + q] = acc[r][c];
    }
  }
}

}  // namespace fp32

// ----------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16)
// ----------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TI = WARPS * 16;    // rows i per row tile: one m16 per warp
constexpr int TJ = 64;            // columns j per tile
constexpr int NT = TJ / 8;        // 8-column n-tiles of a C . B^T tile
constexpr int JW = 4;             // column tiles per window of dt and cs
constexpr int TP = 64;            // p <= TP
constexpr int NK = 64;            // state dims per C / B ring item
constexpr int LDK = NK + 8;       // C / B stage row stride (bf16): 144 B, so
                                  // each 8-row ldmatrix phase hits 32 banks
constexpr int LDX = TP + 8;       // x stage row stride: 144 B, the same
constexpr int STAGES = 3;
constexpr int MAX_HB = 3;         // heads per block

static_assert(TI == TJ, "the diagonal tile is the block's own rows");
static_assert(NK % 16 == 0 && TP % 16 == 0, "m16n8k16 steps");

// A ring stage (bf16) holds one item: a C and a B chunk of NK state dims, or
// the x tiles of the block's HB heads.
template <int HB>
struct Ring {
  static constexpr int CB = 2 * TI * LDK;
  static constexpr int X = HB * TJ * LDX;
  static constexpr int STAGE = CB > X ? CB : X;
};

// dynamic shared memory of a block of HB heads: the ring, then dt and cs of
// the window's columns and cs of the tile's rows for each head
template <int HB>
constexpr int smem_bytes() {
  return STAGES * Ring<HB>::STAGE * 2 + (2 * JW * TJ + TI) * HB * 4;
}

// blocks of HB heads one SM holds: registers (3 heads' y and C . B^T take
// ~230 a thread) and shared memory (228 KB, 1 KB reserved per block)
template <int HB>
constexpr int min_blocks() {
  return HB == 3 ? 2 : 3;
}
template <int HB>
constexpr bool fits() {
  return min_blocks<HB>() * (smem_bytes<HB>() + 1024) <= 233472;
}
static_assert(fits<1>() && fits<2>() && fits<3>() && MAX_HB == 3,
              "shared memory for min_blocks<HB>() blocks per SM");

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
// every group but the newest STAGES - 2 has landed
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
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

// rows [r0, r0 + 64) and columns [c0, c0 + W) of a row-major bf16 matrix
// whose row r starts at src + r * stride, into dst at row stride LD; rows at
// or past `rows` and columns at or past `cols` are 0. vec: 16-byte cp.async
// copies (cols, stride and src are multiples of 8 elements), else element by
// element through registers. Not inlined: its address arithmetic would
// otherwise be hoisted out of the ring loop into registers the heads' y
// need.
template <int W, int LD>
__device__ __noinline__ void stage_tile(bf16* dst, const bf16* src,
                                           long long stride, int r0,
                                           int rows, int c0, int cols,
                                           bool vec, int tid) {
  if (vec) {
    constexpr int CPR = W / 8;                 // 16-byte chunks per row
#pragma unroll
    for (int k = 0; k < 64 * CPR / THREADS; ++k) {
      const int e = tid + k * THREADS;
      const int r = e / CPR, ch = e % CPR, row = r0 + r, col = c0 + ch * 8;
      const bool ok = row < rows && col < cols;
      cp_async16(smem_addr(dst + r * LD + ch * 8),
                 ok ? src + row * stride + col : src, ok);
    }
  } else {
    for (int e = tid; e < 64 * W; e += THREADS) {
      const int r = e / W, c = e % W, row = r0 + r, col = c0 + c;
      dst[r * LD + c] = (row < rows && col < cols)
                            ? src[row * stride + col]
                            : __float2bfloat16(0.f);
    }
  }
}

template <int HB>
__global__ void __launch_bounds__(THREADS, min_blocks<HB>())
ssd_chunk_bf16_mma_kernel(const bf16* __restrict__ x,
                          const float* __restrict__ dt,
                          const float* __restrict__ cs,
                          const bf16* __restrict__ Bm,
                          const bf16* __restrict__ Cm,
                          float* __restrict__ out, int l, int h, int g, int p,
                          int n) {
  constexpr int STAGE = Ring<HB>::STAGE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  float* csw = reinterpret_cast<float*>(smem_raw + STAGES * STAGE * 2);
  float* dtw = csw + HB * JW * TJ;   // [head][window column]
  float* csi = dtw + HB * JW * TJ;   // [head][tile row]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, t4 = lane & 3;   // fragment row / column pair
  const int r0 = warp * 16 + gq, r1 = r0 + 8;   // this thread's tile rows
  const int tiles = (l + TI - 1) / TI;           // row tiles of the chunk
  const int h0 = blockIdx.y * HB;
  const int grp = h0 / (h / g);
  const long long step0 = static_cast<long long>(blockIdx.z) * l;
  const bool vec_x = p % 8 == 0, vec_bc = n % 8 == 0;
  const bf16* xb = x + (step0 * h + h0) * p;     // head h0 + hx at + hx * p
  const long long xs = static_cast<long long>(h) * p;
  const bf16* bgrp = Bm + (step0 * g + grp) * n;   // the group's B and C
  const bf16* cgrp = Cm + (step0 * g + grp) * n;
  const long long bs = static_cast<long long>(g) * n;
  const int nkc = (n + NK - 1) / NK;             // C / B items per column tile
  const int pair = blockIdx.x;

  // the longer row tile of the pair first; an odd count leaves the middle
  // tile alone
  for (int pass = 0; pass < 2; ++pass) {
    const int it = pass == 0 ? tiles - 1 - pair : pair;
    if (pass == 1 && it == tiles - 1 - pair) break;
    const int i0 = it * TI;
    const int i_0 = i0 + r0, i_1 = i0 + r1;
    const bool live = i0 + warp * 16 < l;        // the warp has a row < l
    const bool ragged = i0 + TI > l;

    float acc[HB][TP / 8][4];    // y of each head, 16 rows x 64 per warp
#pragma unroll
    for (int hx = 0; hx < HB; ++hx)
#pragma unroll
      for (int q = 0; q < TP / 8; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[hx][q][e] = 0.f;
    float ci[HB][2];             // cs of this thread's two rows, each head

    for (int w0 = 0; w0 <= it; w0 += JW) {       // windows of column tiles
      const int nj = min(JW, it + 1 - w0);
      // Items, in the order the ring carries them: for each column tile,
      // its nkc C / B chunks, then the x tiles of the HB heads. The chunks
      // of the next tile load while the heads of this one compute.
      const int total = nj * (nkc + 1);
      int next = 0, next_slot = 0, next_k = 0;   // the next item to load
      auto issue = [&]() {
        if (next < total) {
          bf16* st = ring + (next % STAGES) * STAGE;
          const int j0 = (w0 + next_slot) * TJ;
          if (next_k < nkc) {
            stage_tile<NK, LDK>(st, cgrp, bs, i0, l, next_k * NK, n, vec_bc,
                                tid);
            stage_tile<NK, LDK>(st + TI * LDK, bgrp, bs, j0, l, next_k * NK,
                                n, vec_bc, tid);
          } else {
#pragma unroll
            for (int hx = 0; hx < HB; ++hx)
              stage_tile<TP, LDX>(st + hx * TJ * LDX, xb + hx * p, xs, j0, l,
                                  0, p, vec_x, tid);
          }
          if (++next_k > nkc) {
            next_k = 0;
            ++next_slot;
          }
          ++next;
        }
        cp_async_commit();
      };

      __syncthreads();           // the last window's (or pass's) reads are done
#pragma unroll
      for (int k = 0; k < STAGES - 1; ++k) issue();
      if (w0 == 0) {
        for (int e = tid; e < HB * TI; e += THREADS) {
          const int r = e / HB, hx = e % HB, i = i0 + r;
          csi[hx * TI + r] = i < l ? cs[(step0 + i) * h + h0 + hx] : 0.f;
        }
      }
      for (int e = tid; e < HB * nj * TJ; e += THREADS) {
        const int c = e / HB, hx = e % HB, j = w0 * TJ + c;
        const bool ok = j < l;
        csw[hx * JW * TJ + c] = ok ? cs[(step0 + j) * h + h0 + hx] : 0.f;
        dtw[hx * JW * TJ + c] = ok ? dt[(step0 + j) * h + h0 + hx] : 0.f;
      }

      float cb[NT][4];           // C . B^T of the current column tile
      int slot = 0, k = 0;
      for (int t = 0; t < total; ++t) {
        cp_async_wait_ring();
        __syncthreads();         // item t landed; item t - 1 is read
        issue();
        if (w0 == 0 && t == 0) {
#pragma unroll
          for (int hx = 0; hx < HB; ++hx) {
            ci[hx][0] = csi[hx * TI + r0];
            ci[hx][1] = csi[hx * TI + r1];
          }
        }
        const bf16* st = ring + (t % STAGES) * STAGE;

        if (k < nkc) {
          // C . B^T += C[rows, k0 : k0 + NK] B[cols, same]^T
          if (k == 0) {
#pragma unroll
            for (int q = 0; q < NT; ++q)
#pragma unroll
              for (int e = 0; e < 4; ++e) cb[q][e] = 0.f;
          }
          if (live) {
#pragma unroll
            for (int ks = 0; ks < NK / 16; ++ks) {
              uint32_t cf[4];
              ldmatrix_x4(cf, smem_addr(st + (warp * 16 + (lane & 15)) * LDK
                                        + ks * 16 + (lane >> 4) * 8));
#pragma unroll
              for (int np = 0; np < NT / 2; ++np) {
                uint32_t bf[4];
                ldmatrix_x4(bf, smem_addr(
                    st + (TI + np * 16 + (lane & 7) + (lane >> 4) * 8) * LDK
                    + ks * 16 + ((lane >> 3) & 1) * 8));
                mma(cb[2 * np], cf, bf[0], bf[1]);
                mma(cb[2 * np + 1], cf, bf[2], bf[3]);
              }
            }
          }
        } else if (live) {
          // y += S_hi x + S_lo x for each head over column tile w0 + slot
          const int j0 = (w0 + slot) * TJ;
          const bool edge = w0 + slot == it || ragged;   // cuts the mask
#pragma unroll
          for (int hx = 0; hx < HB; ++hx) {
            const float* cj = csw + hx * JW * TJ + slot * TJ;
            const float* dj = dtw + hx * JW * TJ + slot * TJ;
            const bf16* sx = st + hx * TJ * LDX;
#pragma unroll
            for (int kk = 0; kk < TJ / 16; ++kk) {
              uint32_t hi[4], lo[4];
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int q = 2 * kk + half;
                const int jj = q * 8 + 2 * t4;
                const float2 csj = *reinterpret_cast<const float2*>(cj + jj);
                const float2 dtj = *reinterpret_cast<const float2*>(dj + jj);
                // (C.B * L) * dt, the reference's order; element e of the
                // fragment is row (e < 2 ? r0 : r1), column jj + e % 2
                float s0 = __fmul_rn(
                    __fmul_rn(cb[q][0], expf(ci[hx][0] - csj.x)), dtj.x);
                float s1 = __fmul_rn(
                    __fmul_rn(cb[q][1], expf(ci[hx][0] - csj.y)), dtj.y);
                float s2 = __fmul_rn(
                    __fmul_rn(cb[q][2], expf(ci[hx][1] - csj.x)), dtj.x);
                float s3 = __fmul_rn(
                    __fmul_rn(cb[q][3], expf(ci[hx][1] - csj.y)), dtj.y);
                if (edge) {
                  const int j = j0 + jj;
                  const bool ok0 = i_0 < l, ok1 = i_1 < l;
                  s0 = (ok0 && j <= i_0) ? s0 : 0.f;
                  s1 = (ok0 && j + 1 <= i_0) ? s1 : 0.f;
                  s2 = (ok1 && j <= i_1) ? s2 : 0.f;
                  s3 = (ok1 && j + 1 <= i_1) ? s3 : 0.f;
                }
                split(s0, s1, hi[2 * half], lo[2 * half]);
                split(s2, s3, hi[2 * half + 1], lo[2 * half + 1]);
              }
#pragma unroll
              for (int dp = 0; dp < TP / 16; ++dp) {
                if (dp * 16 < p) {
                  uint32_t vf[4];
                  ldmatrix_x4_trans(vf, smem_addr(
                      sx + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8)
                               * LDX
                      + dp * 16 + (lane >> 4) * 8));
                  mma(acc[hx][2 * dp], hi, vf[0], vf[1]);
                  mma(acc[hx][2 * dp], lo, vf[0], vf[1]);
                  mma(acc[hx][2 * dp + 1], hi, vf[2], vf[3]);
                  mma(acc[hx][2 * dp + 1], lo, vf[2], vf[3]);
                }
              }
            }
          }
        }
        if (++k > nkc) {
          k = 0;
          ++slot;
        }
      }
    }

    // y of each head: streaming stores (nothing here reads the output
    // again, so it should not push x, B and C out of L2)
#pragma unroll
    for (int hx = 0; hx < HB; ++hx) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = r ? i_1 : i_0;
        if (i >= l) continue;
        float* orow = out + ((step0 + i) * h + h0 + hx) * p;
#pragma unroll
        for (int q = 0; q < TP / 8; ++q) {
          const int col = q * 8 + 2 * t4;
          const float v0 = acc[hx][q][2 * r], v1 = acc[hx][q][2 * r + 1];
          if (p % 2 == 0 && col < p) {
            __stcs(reinterpret_cast<float2*>(orow + col), make_float2(v0, v1));
          } else {
            if (col < p) __stcs(orow + col, v0);
            if (col + 1 < p) __stcs(orow + col + 1, v1);
          }
        }
      }
    }
  }
}

// The instance for hb heads per block and its dynamic shared memory; false
// for an hb with no instance.
bool instance(int hb, const void** fn, int* bytes) {
  switch (hb) {
    case 1:
      *fn = reinterpret_cast<const void*>(&ssd_chunk_bf16_mma_kernel<1>);
      *bytes = smem_bytes<1>();
      return true;
    case 2:
      *fn = reinterpret_cast<const void*>(&ssd_chunk_bf16_mma_kernel<2>);
      *bytes = smem_bytes<2>();
      return true;
    case 3:
      *fn = reinterpret_cast<const void*>(&ssd_chunk_bf16_mma_kernel<3>);
      *bytes = smem_bytes<3>();
      return true;
    default:
      return false;
  }
}

}  // namespace tc

// Grid of the kernel for dtype (0 = fp32, 1 = bf16) given the caller's
// geometry, or false where that geometry does not cover every (chunk, row
// tile, head) exactly once: fp32 blocks are (row tile, head, chunk); bf16
// blocks (row-tile pair, set of hb heads inside one group, chunk).
bool grid_of(int dtype, int bn, int l, int h, int g, int hb, int gx, int gy,
             dim3* grid) {
  const int nt = (l + tc::TI - 1) / tc::TI;
  if (bn < 1 || bn > 65535 || l < 1 || h < 1 || h > 65535 || g < 1 ||
      h % g != 0)
    return false;
  if (dtype == 0) {
    if (hb != 1 || gx != nt || gy != h) return false;
  } else if (dtype == 1) {
    if (hb < 1 || hb > tc::MAX_HB || (h / g) % hb != 0 ||
        gx != (nt + 1) / 2 || gy != h / hb)
      return false;
  } else {
    return false;
  }
  *grid = dim3((unsigned)gx, (unsigned)gy, (unsigned)bn);
  return true;
}

}  // namespace

// Makes `device` current (this library links its own CUDA runtime, whose
// current device is not PyTorch's), launches on `stream`, does not
// synchronise and returns the launch status. dtype: 0 = fp32 (CUDA cores),
// 1 = bf16 (tensor cores) for x, B and C; bf16 needs them 16-byte aligned.
// (hb, gx, gy): heads per block and the grid's x and y, from
// ops.py::ssd_geometry.
extern "C" int ssd_intra_chunk(const void* x, const float* dt,
                               const float* cs, const void* B, const void* C,
                               float* out, int bn, int l, int h, int g, int p,
                               int n, int hb, int gx, int gy, int dtype,
                               int device, cudaStream_t stream) {
  dim3 grid;
  if (p < 1 || p > tc::TP || n < 1 ||
      !grid_of(dtype, bn, l, h, g, hb, gx, gy, &grid))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    for (const void* ptr : {x, B, C})
      if (reinterpret_cast<uintptr_t>(ptr) % 16)
        return (int)cudaErrorMisalignedAddress;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (dtype == 0) {
    fp32::ssd_chunk_fp32_kernel<<<grid, fp32::THREADS, 0, stream>>>(
        static_cast<const float*>(x), dt, cs, static_cast<const float*>(B),
        static_cast<const float*>(C), out, l, h, g, p, n);
  } else {
    const void* fn;
    int bytes;
    tc::instance(hb, &fn, &bytes);
    const cudaError_t attr = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (attr != cudaSuccess) return (int)attr;
    void* args[] = {&x, &dt, &cs, &B, &C, &out, &l, &h, &g, &p, &n};
    const cudaError_t launch =
        cudaLaunchKernel(fn, grid, dim3(tc::THREADS), args, bytes, stream);
    if (launch != cudaSuccess) return (int)launch;
  }
  return (int)cudaGetLastError();
}

// Blocks of the bf16 kernel with hb heads per block that fit on one SM of
// `device` at once (registers, shared memory and threads), into *blocks.
extern "C" int ssd_bf16_blocks_per_sm(int hb, int device, int* blocks) {
  const void* fn;
  int bytes;
  if (!tc::instance(hb, &fn, &bytes)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn,
                                                        tc::THREADS, bytes);
  return (int)err;
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

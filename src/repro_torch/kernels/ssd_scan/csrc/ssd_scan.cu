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
//
// Bound: operations. The causal half needs l(l+1)/2 * (2n + 2p) flops per
// (chunk, head) against (l(p + 2) + 2ln/(h/g)) * bytes-per-element read and
// 4lp written: at the main path's (l, h, p, n) = (256, 48, 64, 128) in bf16
// that is ~50 flops per byte, above the card's fp32 balance (67 TFLOP/s over
// 3.35 TB/s = 20 flops per byte). This first version computes on the CUDA
// cores in fp32; tensor cores (wgmma) are a later step.
//
// Design. The TPU kernel holds one whole (chunk, head) in VMEM per grid step:
// an (l, l) fp32 score tile plus the chunk's x, B and C, ~208 KiB + 256 KiB at
// l = 256, more than a Hopper block can hold. Here:
//   * block (it, head, chunk) owns 64 rows i of the chunk and all p <= 64
//     output columns, in a 64 x 64 fp32 accumulator spread over 256 threads as
//     4 x 4 register tiles;
//   * it walks the 64-wide column tiles jt = 0 .. it only (the causal half;
//     tiles above the diagonal are never touched);
//   * per tile it forms S = C_i B_j^T in registers, staging 32 state dims of
//     C_i and B_j at a time in shared memory (transposed, so each thread reads
//     its four rows and four columns as one 16-byte load each), then applies
//     S * exp(cs_i - cs_j) * dt_j as a select on j <= i (an exp of a positive
//     argument above the diagonal is never multiplied by a 0), writes S^T over
//     the C / B staging space, stages x_j, and adds S x_j into the
//     accumulator.
// No atomics and a fixed summation order: two launches give the same bits.
// bf16 inputs are widened to fp32 when staged; all arithmetic is fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TI = 64;         // rows i per block
constexpr int TJ = 64;         // columns j per tile
constexpr int TP = 64;         // output columns: p <= TP
constexpr int NK = 32;         // state dims staged per step
constexpr int LD = TI + 4;     // shared row stride: 16-byte aligned rows
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each

static_assert(TI == TJ, "the diagonal tile is the block's own rows");
static_assert(TJ * LD == 2 * NK * LD, "S^T reuses the C / B staging space");

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ cs, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, float* __restrict__ out, int l,
                 int h, int g, int p, int n) {
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
            (i < l && k < n) ? widen(Cm[((step0 + i) * g + grp) * n + k])
                             : 0.f;
        b_s[kk * LD + r] =
            (j < l && k < n) ? widen(Bm[((step0 + j) * g + grp) * n + k])
                             : 0.f;
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
      xs[r * LD + q] =
          (j < l && q < p) ? widen(x[((step0 + j) * h + hd) * p + q]) : 0.f;
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

}  // namespace

// Makes `device` current (this library links its own CUDA runtime, whose
// current device is not PyTorch's), launches on `stream`, does not
// synchronise and returns the launch status. dtype: 0 = fp32, 1 = bf16 for
// x, B and C.
extern "C" int ssd_intra_chunk(const void* x, const float* dt,
                               const float* cs, const void* B, const void* C,
                               float* out, int bn, int l, int h, int g, int p,
                               int n, int dtype, int device,
                               cudaStream_t stream) {
  if (bn < 1 || bn > 65535 || l < 1 || h < 1 || h > 65535 || g < 1 ||
      h % g != 0 || p < 1 || p > TP || n < 1)
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid((unsigned)((l + TI - 1) / TI), (unsigned)h, (unsigned)bn);
  if (dtype == 0) {
    ssd_chunk_kernel<float><<<grid, THREADS, 0, stream>>>(
        static_cast<const float*>(x), dt, cs, static_cast<const float*>(B),
        static_cast<const float*>(C), out, l, h, g, p, n);
  } else if (dtype == 1) {
    ssd_chunk_kernel<__nv_bfloat16><<<grid, THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), dt, cs,
        static_cast<const __nv_bfloat16*>(B),
        static_cast<const __nv_bfloat16*>(C), out, l, h, g, p, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Gradient-sketch projection for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/grad_sketch/kernel.py:116
// sketch_flat (body _sketch_kernel :86, signs _sign_bits :42 / sign_block :63):
// out = G · S for G (n, P) fp32 and S (P, d) = ±1, where S[p, j] is
// regenerated from a uint32 hash of (seed, offset + p, j) and never stored.
//
// Shapes: G (n, P) fp32 contiguous; out (n, d) fp32; partial (C, n, d) fp32
// scratch that the caller allocates (C from grad_sketch_chunks). Any n up to
// 16 · 65535, any d up to 128 · 65535, any P and any offset: positions are
// (offset + p) mod 2^32, as the reference's uint32 casts take them.
//
// Bound: operations. 2·n·P·d flops against 4·n·P bytes read, i.e. d/2 flops
// per byte (128 at d = 256), far above the card's fp32 balance, and on top of
// that one hash of about ten integer operations per (p, j), shared by the n
// rows; the bound the smoke run states counts the flops only.
//
// Design. The TPU kernel walks the position axis in a sequential grid and
// accumulates into one (n, d) output block. CUDA blocks run concurrently and
// in no order, so here:
//   * block (c, y, z) owns a contiguous chunk c of positions, the sketch dims
//     y·128 .. y·128 + 127 (one per thread) and the rows z·16 .. z·16 + 15;
//   * it stages 256 positions of its 16 rows of G in shared memory at a time
//     (coalesced scalar loads: P is odd for the A2C, so rows are not 16-byte
//     aligned; the ragged tail and rows past n are bounds-checked, never
//     padded in memory), and each thread hashes its own (p, j) sign in
//     registers and adds or subtracts the 16 staged values into 16 registers;
//   * it writes its (16, 128) partial sums to partial[c];
//   * a second kernel sums partial[0 .. C-1] for every output element in that
//     fixed order.
// No atomics: two launches on the same input give the same bits. The hash
// runs in uint32_t, so >> is a logical shift and multiplies wrap mod 2^32,
// exactly the reference's jnp.uint32 arithmetic. ±g is exact, so the only
// roundings are the fp32 adds, taken in position order within a chunk and in
// chunk order across chunks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DT = 128;        // sketch dims per block, one per thread
constexpr int RB = 16;         // rows of G per block, one register each
constexpr int TP = 256;        // positions staged in shared memory per step
constexpr long long TARGET_BLOCKS = 16LL * 132;   // ~16 blocks per SM
constexpr uint32_t P1 = 0x9E3779B1u, P2 = 0x85EBCA77u, P3 = 0xC2B2AE3Du;

__device__ __forceinline__ bool negative(uint32_t seed, uint32_t pos,
                                         uint32_t j) {
  uint32_t x = seed + pos * P1 + j * P2;
  x = (x ^ (x >> 15)) * P2;
  x = (x ^ (x >> 13)) * P3;
  x = x ^ (x >> 16);
  return (x >> 31) != 0u;        // bit 1 ⇒ S = 1 - 2 = -1
}

__global__ void __launch_bounds__(DT)
sketch_partial(const float* __restrict__ G, float* __restrict__ partial,
               int n, long long P, int d, uint32_t seed, uint32_t offset,
               long long chunk) {
  __shared__ float gs[RB][TP];
  const int c = blockIdx.x;
  const int j = blockIdx.y * DT + threadIdx.x;
  const int r0 = blockIdx.z * RB;
  const int rows = min(RB, n - r0);
  const long long p_begin = (long long)c * chunk;
  const long long p_end = min(P, p_begin + chunk);

  float acc[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) acc[r] = 0.f;

  for (long long base = p_begin; base < p_end; base += TP) {
    const int width = (int)min((long long)TP, p_end - base);
    __syncthreads();               // the previous step's reads are done
    for (int idx = threadIdx.x; idx < RB * TP; idx += DT) {
      const int r = idx / TP, q = idx % TP;
      gs[r][q] = (r < rows && q < width)
                     ? __ldg(G + (long long)(r0 + r) * P + base + q)
                     : 0.f;
    }
    __syncthreads();
    if (j < d) {
      for (int q = 0; q < width; ++q) {
        const bool neg = negative(seed, offset + (uint32_t)(base + q),
                                  (uint32_t)j);
#pragma unroll
        for (int r = 0; r < RB; ++r)
          acc[r] = neg ? __fsub_rn(acc[r], gs[r][q])
                       : __fadd_rn(acc[r], gs[r][q]);
      }
    }
  }
  if (j < d) {
    for (int r = 0; r < rows; ++r)
      partial[((long long)c * n + r0 + r) * d + j] = acc[r];
  }
}

__global__ void sketch_reduce(const float* __restrict__ partial,
                              float* __restrict__ out, int chunks,
                              long long count) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < count; i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < chunks; ++c)
      s = __fadd_rn(s, partial[(long long)c * count + i]);
    out[i] = s;
  }
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

// The number of position chunks C (the partial buffer is (C, n, d) fp32) and
// their length, a multiple of the 256-position staging step: enough chunks
// that the grid has about TARGET_BLOCKS blocks, never one shorter than a step.
extern "C" int grad_sketch_chunks(int n, long long P, int d,
                                  long long* chunk) {
  const long long others = ceil_div(d, DT) * ceil_div(n, RB);
  long long want = ceil_div(TARGET_BLOCKS, others);
  const long long most = ceil_div(P, TP);
  if (want > most) want = most;
  if (want < 1) want = 1;
  *chunk = ceil_div(ceil_div(P, want), TP) * TP;
  return (int)ceil_div(P, *chunk);
}

// Makes `device` current (this library links its own CUDA runtime, whose
// current device is not PyTorch's), launches both passes on `stream`, does
// not synchronise and returns the launch status for the caller to check.
extern "C" int grad_sketch(const float* G, float* partial, float* out, int n,
                           long long P, int d, uint32_t seed, uint32_t offset,
                           long long chunk, int chunks, int device,
                           cudaStream_t stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid((unsigned)chunks, (unsigned)ceil_div(d, DT),
                  (unsigned)ceil_div(n, RB));
  sketch_partial<<<grid, DT, 0, stream>>>(G, partial, n, P, d, seed, offset,
                                          chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long count = (long long)n * d;
  const long long blocks = ceil_div(count, 256);
  sketch_reduce<<<(unsigned)(blocks < 65535 ? blocks : 65535), 256, 0,
                  stream>>>(partial, out, chunks, count);
  return (int)cudaGetLastError();
}

extern "C" const char* grad_sketch_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

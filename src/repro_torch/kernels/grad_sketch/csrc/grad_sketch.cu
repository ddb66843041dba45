// Gradient-sketch projection for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/grad_sketch/kernel.py:116
// sketch_flat (body _sketch_kernel :86, signs _sign_bits :42 / sign_block :63):
// out = G · S for G (n, P) fp32 and S (P, d) = ±1, where S[p, j] is
// regenerated from a uint32 hash of (seed, offset + p, j) and never stored.
//
// Shapes: G (n, P) fp32 contiguous; out (n, d) fp32; partial (C, n, d) fp32
// scratch that the caller allocates. Any n up to 16 · 65535, any d up to
// 128 · 65535, any P and any offset: positions are (offset + p) mod 2^32, as
// the reference's uint32 casts take them. The launch geometry (rows per
// block, chunk length, chunk count, the second pass's blocks) comes from the
// caller, ops.py::sketch_geometry.
//
// Bound: operations. 2·n·P·d flops against 4·n·P bytes read, i.e. d/2 flops
// per byte (128 at d = 256), far above the card's fp32 balance, and on top of
// that one hash of about eight integer operations per (p, j), shared by the
// n rows; the bound the smoke run states counts the flops only. At the main
// path's (8, 9155, 256) the whole job is a few microseconds of issue spread
// over the card, so the design's first aim is that every SM has many warps
// with short, independent chains.
//
// Design. The TPU kernel walks the position axis in a sequential grid and
// accumulates into one (n, d) output block. CUDA blocks run concurrently and
// in no order, so here:
//   * block (c, y, z) owns a contiguous chunk c of `chunk` positions (a
//     multiple of UNROLL; 32 at the main path, so 287 chunks and 574 blocks),
//     the sketch dims y·128 .. y·128 + 127 (one per thread) and the rows
//     z·RB .. z·RB + RB - 1, RB a template parameter (1, 2, 4, 8 or 16: the
//     power of two that covers n, so n = 8 adds no zero rows);
//   * it stages up to STAGE positions of its RB rows of G in shared memory at
//     a time (coalesced scalar loads: P is odd for the A2C, so rows are not
//     16-byte aligned; the ragged tail and rows past n are zero-filled in
//     shared memory, never padded in device memory);
//   * each thread walks the staged positions UNROLL at a time: it hashes the
//     UNROLL signs of its column first (independent chains, in flight
//     together), then reads each row's UNROLL values as float4s (one
//     broadcast read for the warp) and folds them as acc += s·g, an FMA whose
//     product ±g is exact, so it rounds as acc ± g does;
//   * it writes its (RB, 128) partial sums to partial[c];
//   * a second kernel sums partial[0 .. C-1] for every output element: 32
//     consecutive outputs per block row, REDUCE_ROWS threads per output each
//     summing every REDUCE_ROWS-th chunk in order, then a fixed tree over
//     those REDUCE_ROWS sums in shared memory.
// A shard of a leaf (the model axis of a (data, model) mesh) is a strided
// set of the leaf's positions: local element q of a row of G sits at position
// offset + (q / width) · stride + c0 + q % width of the full leaf (a column
// shard of the leaf viewed as (rows, stride)). The STRIDED instances take
// that map: while a block stages its G values it also writes each staged
// position's hash term (offset + pos)·P1 to shared memory (one 64-bit
// division per staged position and block, not per sign), and the fold reads
// it in place of the running x0 + u·P1. A contiguous shard is passed as a
// plain offset and takes the contiguous instances.
// No atomics: two launches on the same input give the same bits. The hash
// runs in uint32_t, so >> is a logical shift and multiplies wrap mod 2^32,
// exactly the reference's jnp.uint32 arithmetic. Its last step,
// x ^ (x >> 16), leaves the top bit as it is, so the sign is the top bit
// before it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DT = 128;          // sketch dims per block, one per thread
constexpr int STAGE = 256;       // positions staged in shared memory per step
constexpr int UNROLL = 8;        // positions hashed together per thread
constexpr int REDUCE_ROWS = 16;  // threads per output in the second pass
constexpr uint32_t P1 = 0x9E3779B1u, P2 = 0x85EBCA77u, P3 = 0xC2B2AE3Du;

static_assert(STAGE % UNROLL == 0 && UNROLL % 4 == 0, "float4 reads");
static_assert(STAGE % DT == 0, "each thread stages STAGE / DT positions");

// The sign S[pos, j] as ±1.0f, from x0 = seed + j·P2 + pos·P1 (mod 2^32):
// the reference's _sign_bits without its last x ^ (x >> 16), which does not
// change the top bit. Bit 1 ⇒ S = 1 - 2 = -1: the bit goes into the sign of
// 1.0f.
__device__ __forceinline__ float sign_of(uint32_t x) {
  x = (x ^ (x >> 15)) * P2;
  x = (x ^ (x >> 13)) * P3;
  return __uint_as_float((x & 0x80000000u) | 0x3f800000u);
}

template <int RB, bool STRIDED>
__global__ void __launch_bounds__(DT)
sketch_partial(const float* __restrict__ G, float* __restrict__ partial,
               int n, long long P, int d, uint32_t seed, uint32_t offset,
               long long chunk, unsigned long long map_stride,
               unsigned long long map_c0, unsigned long long map_width) {
  __shared__ __align__(16) float gs[RB][STAGE];
  __shared__ __align__(16) uint32_t hp[STRIDED ? STAGE : 1];
  const int c = blockIdx.x;
  const int j = blockIdx.y * DT + threadIdx.x;
  const int r0 = blockIdx.z * RB;
  const int rows = min(RB, n - r0);
  const long long p_begin = (long long)c * chunk;
  const long long p_end = min(P, p_begin + chunk);
  // seed + j·P2, the part of the hash's first sum that is fixed per thread
  const uint32_t hj = seed + (uint32_t)j * P2;

  float acc[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) acc[r] = 0.f;

  for (long long base = p_begin; base < p_end; base += STAGE) {
    const int width = (int)min((long long)STAGE, p_end - base);
    const int span = (width + UNROLL - 1) / UNROLL * UNROLL;
    // every load of the step is issued before the first store to shared
    float v[RB][STAGE / DT];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
#pragma unroll
      for (int k = 0; k < STAGE / DT; ++k) {
        const int q = threadIdx.x + k * DT;
        v[r][k] = (r < rows && q < width)
                      ? __ldg(G + (long long)(r0 + r) * P + base + q)
                      : 0.f;
      }
    }
    __syncthreads();               // the previous step's reads are done
#pragma unroll
    for (int r = 0; r < RB; ++r) {
#pragma unroll
      for (int k = 0; k < STAGE / DT; ++k) {
        const int q = threadIdx.x + k * DT;
        if (q < span) gs[r][q] = v[r][k];
      }
    }
    if (STRIDED) {
#pragma unroll
      for (int k = 0; k < STAGE / DT; ++k) {
        const int q = threadIdx.x + k * DT;
        if (q < span) {
          const unsigned long long lq = (unsigned long long)(base + q);
          const unsigned long long row = lq / map_width;
          const uint32_t pos = (uint32_t)(row * map_stride + map_c0 +
                                          (lq - row * map_width));
          hp[q] = (offset + pos) * P1;
        }
      }
    }
    __syncthreads();
    if (j < d) {
      uint32_t x0 = hj + (offset + (uint32_t)base) * P1;
      for (int q = 0; q < span; q += UNROLL, x0 += UNROLL * P1) {
        float s[UNROLL];
        if (STRIDED) {
#pragma unroll
          for (int u4 = 0; u4 < UNROLL; u4 += 4) {
            const uint4 h = *reinterpret_cast<const uint4*>(&hp[q + u4]);
            s[u4 + 0] = sign_of(hj + h.x);
            s[u4 + 1] = sign_of(hj + h.y);
            s[u4 + 2] = sign_of(hj + h.z);
            s[u4 + 3] = sign_of(hj + h.w);
          }
        } else {
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) s[u] = sign_of(x0 + u * P1);
        }
#pragma unroll
        for (int r = 0; r < RB; ++r) {
#pragma unroll
          for (int u4 = 0; u4 < UNROLL; u4 += 4) {
            const float4 g = *reinterpret_cast<const float4*>(&gs[r][q + u4]);
            acc[r] = fmaf(s[u4 + 0], g.x, acc[r]);
            acc[r] = fmaf(s[u4 + 1], g.y, acc[r]);
            acc[r] = fmaf(s[u4 + 2], g.z, acc[r]);
            acc[r] = fmaf(s[u4 + 3], g.w, acc[r]);
          }
        }
      }
    }
  }
  if (j < d) {
#pragma unroll
    for (int r = 0; r < RB; ++r)
      if (r < rows) partial[((long long)c * n + r0 + r) * d + j] = acc[r];
  }
}

// out[i] = Σ_c partial[c][i] over the `chunks` partial sums of each of the
// `count` = n·d outputs, in a fixed order: thread (x, y) of a (32,
// REDUCE_ROWS) block sums chunks y, y + REDUCE_ROWS, ... of output
// group·32 + x in that order; the REDUCE_ROWS sums then meet in a fixed
// pairwise tree. Blocks stride over the output groups.
__global__ void __launch_bounds__(32 * REDUCE_ROWS)
sketch_reduce(const float* __restrict__ partial, float* __restrict__ out,
              int chunks, long long count) {
  __shared__ float part[REDUCE_ROWS][33];
  const int x = threadIdx.x, y = threadIdx.y;
  for (long long group = blockIdx.x; group * 32 < count;
       group += gridDim.x) {
    const long long i = group * 32 + x;
    float s = 0.f;
    if (i < count) {
      int c = y;
#pragma unroll 4
      for (; c < chunks; c += REDUCE_ROWS)
        s = __fadd_rn(s, __ldg(partial + (long long)c * count + i));
    }
    part[y][x] = s;
    __syncthreads();
#pragma unroll
    for (int half = REDUCE_ROWS / 2; half > 0; half /= 2) {
      if (y < half) part[y][x] = __fadd_rn(part[y][x], part[y + half][x]);
      __syncthreads();
    }
    if (y == 0 && i < count) out[i] = part[0][x];
    __syncthreads();               // part is reused by the next group
  }
}

template <int RB>
cudaError_t launch_partial(dim3 grid, cudaStream_t stream, const float* G,
                           float* partial, int n, long long P, int d,
                           uint32_t seed, uint32_t offset, long long chunk,
                           long long stride, long long c0, long long width) {
  if (width > 0)
    sketch_partial<RB, true><<<grid, DT, 0, stream>>>(
        G, partial, n, P, d, seed, offset, chunk,
        (unsigned long long)stride, (unsigned long long)c0,
        (unsigned long long)width);
  else
    sketch_partial<RB, false><<<grid, DT, 0, stream>>>(
        G, partial, n, P, d, seed, offset, chunk, 0ull, 0ull, 1ull);
  return cudaGetLastError();
}

}  // namespace

// Makes `device` current (this library links its own CUDA runtime, whose
// current device is not PyTorch's), launches both passes on `stream`, does
// not synchronise and returns the launch status for the caller to check.
// The geometry is the caller's: `rows` rows per block (1, 2, 4, 8 or 16),
// chunks of `chunk` positions (a multiple of 8), `chunks` = ⌈P / chunk⌉,
// and `reduce_blocks` blocks for the second pass. `width` > 0 takes the
// strided position map (row `stride`, column offset `c0`, local `width`);
// `width` = 0 the contiguous positions offset + p.
extern "C" int grad_sketch(const float* G, float* partial, float* out, int n,
                           long long P, int d, uint32_t seed, uint32_t offset,
                           long long stride, long long c0, long long width,
                           int rows, long long chunk, int chunks,
                           int reduce_blocks, int device,
                           cudaStream_t stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (chunk < 1 || chunk % UNROLL || (long long)chunks * chunk < P ||
      reduce_blocks < 1 || width < 0 || (width > 0 && (P % width ||
                                                       stride < width ||
                                                       c0 + width > stride)))
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)chunks, (unsigned)((d + DT - 1) / DT),
                  (unsigned)((n + rows - 1) / rows));
  cudaError_t err;
  switch (rows) {
    case 1: err = launch_partial<1>(grid, stream, G, partial, n, P, d, seed,
                                    offset, chunk, stride, c0, width); break;
    case 2: err = launch_partial<2>(grid, stream, G, partial, n, P, d, seed,
                                    offset, chunk, stride, c0, width); break;
    case 4: err = launch_partial<4>(grid, stream, G, partial, n, P, d, seed,
                                    offset, chunk, stride, c0, width); break;
    case 8: err = launch_partial<8>(grid, stream, G, partial, n, P, d, seed,
                                    offset, chunk, stride, c0, width); break;
    case 16: err = launch_partial<16>(grid, stream, G, partial, n, P, d, seed,
                                    offset, chunk, stride, c0, width); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  sketch_reduce<<<(unsigned)reduce_blocks, dim3(32, REDUCE_ROWS), 0,
                  stream>>>(partial, out, chunks, (long long)n * d);
  return (int)cudaGetLastError();
}

extern "C" const char* grad_sketch_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Block-sparse SpMM for Hopper (sm_90a): Y = A^T . X over stored blocks.
//
// Replaces the TPU kernel src/repro/kernels/block_spmm/block_spmm.py:48
// (block_spmm, body _kernel :26, pallas_call :63). For every destination
// column block c and every feature f:
//
//   Y[c*B + v][f] = sum over blocks i of column c, sum over u of
//                   blocks[i][u][v] * X[rows[i]*B + u][f]
//
// with blocks and X both in float32 or both in bfloat16, and a float32
// sum.
//
// What bounds it on an H100: bytes. Every stored B x B tile is read once
// (128 x 128 float32 = 64 KB; 122,958 tiles = 8.06 GB for the LDBC proxy
// at scale 10, 2.42 ms at 3.35 TB/s), but the tiles are sparse: about 12
// nonzeros in 16,384 entries. A dense per-tile product would do 5.2e11
// float32 operations (7.7 ms at 67 TFLOP/s, above the bytes bound), so
// this kernel SKIPS ZERO ENTRIES: it reads each tile once, finds its
// nonzeros with warp ballots and does F fused multiply-adds per nonzero.
// Consequence: an entry equal to 0 (or -0) contributes nothing even where
// X holds inf or NaN, while the dense plain version and the TPU kernel give
// 0 * inf = NaN there. A NaN stored in a tile counts as nonzero.
//
// The TPU kernel carries each output tile in VMEM across a sequential grid
// of blocks. Hopper runs blocks in no order, so instead one CTA owns one
// (column block, feature tile of min(F, 128)) output: the blocks of column
// c are col_ptr[c]..col_ptr[c+1] (block_cols is sorted), the CTA walks them
// in order, keeps the B x FT float32 sum in shared memory and writes it
// once. No atomics: the result is the same bits run to run, and a column
// with no block is written as zeros. Each of the 8 warps owns a strip of
// B/8 destination columns v of every tile, so no two warps touch the same
// row of the sum. B is a power of two (8..256), so a lane's place in the
// strip is shifts and masks, not divisions. A warp streams its strip with
// 32 loads in flight per lane, requested one step ahead of their use and
// marked evict-first (__ldcs: the tiles are read once, the features again
// and again, so the features keep the L2); for each nonzero (u, v, a), in
// (u, v) order, its 32 lanes add a * X[row*B + u][f0:f0+FT] into row v,
// two nonzeros' feature rows fetched together. Plain float32 FMAs, never
// TF32. Besides the tile stream, each nonzero costs a shuffle, a feature
// row gather and FT shared-memory adds; an operand that stores only the
// nonzeros (CSR-like), or a tensor-core design, is later work.
//
// Launches on the caller's stream, allocates nothing, writes every element
// of Y, and returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 32;  // tile loads in flight per lane
constexpr int kBatch = 2;  // nonzeros whose feature rows load together
constexpr int kMinBlocks = 2;  // CTAs per SM the register budget allows
constexpr int kMaxFeatTile = 128;
constexpr int kFeatLoads = kMaxFeatTile / 32;  // feature loads per lane

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// A tile entry, read once: streamed past the caches (evict first) so that
// the features, which every tile reads again, stay in L2.
__device__ __forceinline__ float tile_load(const float* p) {
  return __ldcs(p);
}
__device__ __forceinline__ float tile_load(const __nv_bfloat16* p) {
  const unsigned short bits =
      __ldcs(reinterpret_cast<const unsigned short*>(p));
  return __bfloat162float(__ushort_as_bfloat16(bits));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    spmm_kernel(const T* __restrict__ blocks,
                const int32_t* __restrict__ rows,
                const long long* __restrict__ col_ptr, long long g_sb,
                const T* __restrict__ x, int B, int F, int FT,
                float* __restrict__ y) {
  extern __shared__ float acc[];  // [B][FT]
  const long long c = blockIdx.x;
  const int f0 = blockIdx.y * FT;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < B * FT; i += kThreads) acc[i] = 0.f;
  __syncthreads();
  // B is a power of two in [8, 256]: warp w owns the cw = B / 8 columns
  // v0..v0+cw-1; a load instruction covers 32 / cw rows of that strip
  const int cw = B / kWarps;
  const int log_cw = __ffs(cw) - 1;
  const int v0 = warp * cw;
  const int du = lane >> log_cw;         // row of this lane in a load
  const int dv = lane & (cw - 1);        // column of this lane
  const int rows_per_load = 32 >> log_cw;
  const int rows_per_step = kUnroll * rows_per_load;
  const int steps = (B + rows_per_step - 1) / rows_per_step;
  const long long lo = c < g_sb ? col_ptr[c] : 0;
  const long long hi = c < g_sb ? col_ptr[c + 1] : 0;
  float cur[kUnroll], nxt[kUnroll];
  auto fetch = [&](long long i, int s, float* v) {
    const T* a = blocks + i * B * B + v0 + dv;
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int u = s * rows_per_step + k * rows_per_load + du;
      v[k] = u < B ? tile_load(a + u * B) : 0.f;
    }
  };
  if (lo < hi) fetch(lo, 0, cur);
  long long i = lo;
  int s = 0;
  while (i < hi) {
    long long ni = i;
    int ns = s + 1;
    if (ns == steps) {
      ns = 0;
      ++ni;
    }
    if (ni < hi) fetch(ni, ns, nxt);  // in flight while cur is used
    const T* xs = x + (long long)rows[i] * B * F + f0;
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int ub = s * rows_per_step + k * rows_per_load;
      unsigned mask = __ballot_sync(0xffffffffu, cur[k] != 0.f);
      while (mask) {
        // up to kBatch nonzeros in (u, v) order: their feature rows are
        // fetched together, then added in that order
        int src[kBatch];
        float w[kBatch], xv[kBatch][kFeatLoads];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          src[b] = mask ? __ffs(mask) - 1 : -1;
          mask &= mask - 1;
          w[b] = __shfl_sync(0xffffffffu, cur[k], src[b] < 0 ? 0 : src[b]);
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const T* xr = xs + (long long)(ub + (src[b] >> log_cw)) * F;
#pragma unroll
          for (int j = 0; j < kFeatLoads; ++j) {
            const int f = lane + 32 * j;
            xv[b][j] = src[b] >= 0 && f < FT ? to_f32(xr[f]) : 0.f;
          }
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if (src[b] < 0) break;
          float* yr = acc + (v0 + (src[b] & (cw - 1))) * FT;
#pragma unroll
          for (int j = 0; j < kFeatLoads; ++j) {
            const int f = lane + 32 * j;
            if (f < FT) yr[f] = fmaf(w[b], xv[b][j], yr[f]);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) cur[k] = nxt[k];
    i = ni;
    s = ns;
  }
  __syncthreads();
  float* out = y + c * B * F + f0;
  for (int i = threadIdx.x; i < B * FT; i += kThreads)
    out[(long long)(i / FT) * F + i % FT] = acc[i];
}

template <typename T>
int launch(const void* blocks, const void* rows, const void* col_ptr,
           long long g_sb, const void* x, long long g, int B, int F,
           void* y, cudaStream_t stream) {
  const int ft = F < kMaxFeatTile ? F : kMaxFeatTile;
  const size_t smem = sizeof(float) * B * ft;
  auto kern = spmm_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((unsigned)g, (unsigned)(F / ft));
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(blocks), static_cast<const int32_t*>(rows),
      static_cast<const long long*>(col_ptr), g_sb,
      static_cast<const T*>(x), B, F, ft, static_cast<float*>(y));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// blocks [nb, B, B] and x [g, B, F], both float32 or both bfloat16 (when
// bf16), rows [nb] int32, col_ptr [g_sb + 1] int64 (column c's blocks are
// col_ptr[c]..col_ptr[c+1]), y [g, B, F] float32. Needs g >= g_sb, every
// row id < g, B a power of two in [8, 256] and F % min(F, 128) == 0.
int block_spmm_launch(const void* blocks, const void* rows,
                      const void* col_ptr, long long g_sb, const void* x,
                      int bf16, long long g, int B, int F, void* y,
                      void* stream) {
  if (g <= 0 || F <= 0) return (int)cudaGetLastError();
  const int ft = F < kMaxFeatTile ? F : kMaxFeatTile;
  if (B < 8 || B > 256 || (B & (B - 1)) || F % ft != 0 || g_sb > g ||
      g > 0x7fffffffLL || F / ft > 65535)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(blocks, rows, col_ptr, g_sb, x, g, B, F, y,
                                 s);
  return launch<float>(blocks, rows, col_ptr, g_sb, x, g, B, F, y, s);
}

const char* block_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Block-sparse SpMM for Hopper (sm_90a): Y = A^T . X over the nonzeros of
// the stored blocks.
//
// Replaces the TPU kernel src/repro/kernels/block_spmm/block_spmm.py:48
// (block_spmm, body _kernel :26, pallas_call :63). For every destination
// v = c*B + j and every feature f:
//
//   Y[v][f] = sum over blocks i of column c, sum over k of
//             blocks[i][k][j] * X[rows[i]*B + k][f]
//
// with blocks and X both in float32 or both in bfloat16, and a float32
// sum.
//
// The operand. The TPU kernel multiplies dense B x B tiles on its matrix
// unit. On the LDBC proxy at scale 10 the 122,958 tiles of 128 x 128 hold
// about 12 nonzeros in 16,384 entries (8.06 GB of tiles for 1.47M
// nonzeros), so streaming tiles cannot come near a sparse library. This
// kernel reads a view compacted once from the tiles (ops.SpmmNonzeros): the
// nonzeros by destination (int32 source id and weight, in (block, k)
// order, which is ascending source id) and a work list of chunks of at
// most `chunk` nonzeros (v, lo, hi, slot).
//
// What bounds it on an H100: the gather of source rows. The work's own
// bytes are the nonzeros (4 + 4 bytes each in float32), the offsets, X and
// Y: about 58 MB at scale 10, F 128, 0.0174 ms at 3.35 TB/s. But each
// nonzero gathers its source's feature row: 1.47M x 512 B = 754 MB pulled
// through L2, from a 23 MB X that stays resident in the 50 MB L2. That L2
// gather is the realistic limit, and the design keeps it the only large
// stream: one warp per chunk; for F = 128 float32 each lane holds 4
// features, so a source row is one 512-byte coalesced load (16 bytes a
// lane); the warp reads 32 (source, weight) pairs at a time, coalesced and
// evict-first (read once), and broadcasts them by shuffle; each lane keeps
// kInFlight rows requested before it adds the first, in nonzero order,
// with float32 FMAs (never TF32). X is read under an evict-last L2 policy
// and Y written with streaming stores, so that X keeps the L2. Features
// are tiled by FT = min(F, 128) (grid y); FT 128 on a 16-byte aligned X
// takes 4 features a lane, any other FT a strided, masked form (the same
// per-feature order of sums, so the same bits). The work list comes
// longest chunk first (the build sorts it): a chunk of 256 nonzeros is
// 64 dependent rounds of gathers, so one that started last would hold the
// whole grid; 4 rows in flight and 4-warp CTAs keep registers at about 40
// a thread and the SMs full of warps. Both measured on the card
// (scripts/spmm_chunk_sweep.py, PERF.md).
//
// Long destinations are split: the scale-10 graph's largest in-degree is
// 23,917 against a median of 12, so one warp per destination would wait on
// its longest row. A destination with one chunk writes Y directly. The
// chunks of a longer one write float32 partial sums to rows of a scratch
// buffer (the wrapper allocates it), and a second pass in the same entry
// point adds them in chunk order. No float atomics: the same bits every
// run. Destinations with no nonzero have one empty chunk and are written
// as zeros, as are rows of Y past the adjacency.
//
// Zero entries are not in the view: an entry equal to 0 (or -0)
// contributes nothing even where X holds inf or NaN, while the dense plain
// version and the TPU kernel give 0 * inf = NaN there. A NaN stored in a
// tile is a nonzero.
//
// Launches on the caller's stream, allocates nothing, writes every element
// of Y, and returns cudaGetLastError() after the launches.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kInFlight = 4;  // source rows a lane has requested at once
constexpr int kMaxFeatTile = 128;
constexpr int V = kMaxFeatTile / 32;  // features a lane holds
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// A nonzero's weight, read once: evict first, so that X keeps the L2.
__device__ __forceinline__ float weight(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float weight(const __nv_bfloat16* p) {
  const unsigned short bits =
      __ldcs(reinterpret_cast<const unsigned short*>(p));
  return __bfloat162float(__ushort_as_bfloat16(bits));
}

// An L2 policy that keeps lines (evict last): for X, which every chunk
// gathers from, while the nonzeros stream past and Y is written once.
__device__ __forceinline__ uint64_t keep_policy() {
  uint64_t pol;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}

// N 32-bit words of X at p (16- or 8-byte aligned), read-only, under the
// evict-last policy.
template <int N>
__device__ __forceinline__ void load_words(const void* p, uint64_t pol,
                                           uint32_t (&w)[N]) {
  static_assert(N == 4 || N == 2, "a 16- or 8-byte load");
  if constexpr (N == 4) {
    asm volatile(
        "ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;\n"
        : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
        : "l"(p), "l"(pol));
  } else {
    asm volatile("ld.global.nc.L2::cache_hint.v2.u32 {%0, %1}, [%2], %3;\n"
                 : "=r"(w[0]), "=r"(w[1])
                 : "l"(p), "l"(pol));
  }
}

// V consecutive features of a source row into floats, one load a lane.
__device__ __forceinline__ void load_row(const float* p, uint64_t pol,
                                         float (&v)[V]) {
  uint32_t w[V];
  load_words<V>(p, pol, w);
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = __uint_as_float(w[j]);
}
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         uint64_t pol, float (&v)[V]) {
  uint32_t w[V / 2];
  load_words<V / 2>(p, pol, w);
#pragma unroll
  for (int j = 0; j < V / 2; ++j) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[j]));
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

// The features of a row that lane `lane` owns: V consecutive ones at
// lane*V (STRIDED false, FT 128), or lane + 32*j for j < V, below ft
// (true).
template <typename T, bool STRIDED>
__device__ __forceinline__ void gather(const T* row, int lane, int ft,
                                       uint64_t pol, float (&v)[V]) {
  if constexpr (STRIDED) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int f = lane + 32 * j;
      v[j] = f < ft ? to_f32(row[f]) : 0.f;
    }
  } else {
    load_row(row + lane * V, pol, v);
  }
}

// Written once and not read again here: streaming stores (evict first).
template <bool STRIDED>
__device__ __forceinline__ void store(float* row, int lane, int ft,
                                      const float (&v)[V]) {
  if constexpr (STRIDED) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int f = lane + 32 * j;
      if (f < ft) __stcs(row + f, v[j]);
    }
  } else {
    __stcs(reinterpret_cast<float4*>(row + lane * V),
           make_float4(v[0], v[1], v[2], v[3]));
  }
}

// Pass 1: warp w < n_items sums item w = (v, lo, hi, slot) into Y[v] (slot
// -1) or into partial row `slot`; warps past the items zero the rows of Y
// from n_dst on. Feature tile blockIdx.y.
template <typename T, bool STRIDED>
__global__ void __launch_bounds__(kThreads)
    spmm_chunks(const int32_t* __restrict__ src, const T* __restrict__ val,
                const int4* __restrict__ items, long long n_items,
                long long n_dst, long long n_rows, const T* __restrict__ x,
                int F, int FT, float* __restrict__ y,
                float* __restrict__ part) {
  const long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int f0 = blockIdx.y * FT;
  const uint64_t pol = keep_policy();
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
  float* out;
  if (w < n_items) {
    const int4 it = __ldcs(items + w);
    for (int base = it.y; base < it.z; base += 32) {
      const int n = min(32, it.z - base);
      int s = 0;
      float a = 0.f;
      if (lane < n) {
        s = __ldcs(src + base + lane);
        a = weight(val + base + lane);
      }
      for (int t = 0; t < n; t += kInFlight) {
        float xv[kInFlight][V];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const int su = __shfl_sync(kFull, s, t + u);
          if (t + u < n) {
            gather<T, STRIDED>(x + (long long)su * F + f0, lane, FT,
                                  pol, xv[u]);
          } else {
#pragma unroll
            for (int j = 0; j < V; ++j) xv[u][j] = 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const float au = __shfl_sync(kFull, a, t + u);
          if (t + u < n) {
#pragma unroll
            for (int j = 0; j < V; ++j) acc[j] = fmaf(au, xv[u][j], acc[j]);
          }
        }
      }
    }
    out = it.w < 0 ? y + (long long)it.x * F : part + (long long)it.w * F;
  } else {
    const long long row = n_dst + (w - n_items);
    if (row >= n_rows) return;
    out = y + row * F;
  }
  store<STRIDED>(out + f0, lane, FT, acc);
}

// Pass 2: warp w adds the partial rows slot_lo..slot_hi of split w =
// (v, slot_lo, slot_hi) in chunk order into Y[v].
__global__ void __launch_bounds__(kThreads)
    spmm_splits(const int32_t* __restrict__ splits, long long n_split,
                const float* __restrict__ part, int F, int FT,
                float* __restrict__ y) {
  const long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= n_split) return;
  const int lane = threadIdx.x & 31;
  const int v = splits[3 * w];
  const int lo = splits[3 * w + 1];
  const int hi = splits[3 * w + 2];
  for (int f = blockIdx.y * FT + lane; f < (blockIdx.y + 1) * FT; f += 32) {
    float s = 0.f;
    for (int p = lo; p < hi; ++p) s += part[(long long)p * F + f];
    y[(long long)v * F + f] = s;
  }
}

template <typename T, bool STRIDED>
int launch(const void* src, const void* val, const void* items,
           long long n_items, const void* splits, long long n_split,
           long long n_dst, const void* x, long long n_rows, int F, int ft,
           void* y, void* part, cudaStream_t stream) {
  const long long warps = n_items + (n_rows - n_dst);
  dim3 grid((unsigned)((warps + kWarps - 1) / kWarps), (unsigned)(F / ft));
  spmm_chunks<T, STRIDED><<<grid, kThreads, 0, stream>>>(
      static_cast<const int32_t*>(src), static_cast<const T*>(val),
      static_cast<const int4*>(items), n_items, n_dst, n_rows,
      static_cast<const T*>(x), F, ft, static_cast<float*>(y),
      static_cast<float*>(part));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 0) return (int)err;
  dim3 grid2((unsigned)((n_split + kWarps - 1) / kWarps),
             (unsigned)(F / ft));
  spmm_splits<<<grid2, kThreads, 0, stream>>>(
      static_cast<const int32_t*>(splits), n_split,
      static_cast<const float*>(part), F, ft, static_cast<float*>(y));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(const void* src, const void* val, const void* items,
             long long n_items, const void* splits, long long n_split,
             long long n_dst, const void* x, long long n_rows, int F,
             void* y, void* part, cudaStream_t s) {
  const int ft = F < kMaxFeatTile ? F : kMaxFeatTile;
  const uintptr_t at = reinterpret_cast<uintptr_t>(x);
  if (ft == kMaxFeatTile && at % (V * sizeof(T)) == 0)
    return launch<T, false>(src, val, items, n_items, splits, n_split,
                            n_dst, x, n_rows, F, ft, y, part, s);
  return launch<T, true>(src, val, items, n_items, splits, n_split, n_dst,
                         x, n_rows, F, ft, y, part, s);
}

}  // namespace

extern "C" {

// src [nnz] int32, val [nnz] and x [n_rows, F] both float32 or both
// bfloat16 (when bf16), items [n_items] int4 (v, lo, hi, slot), splits
// [n_split, 3] int32 (v, slot_lo, slot_hi), y [n_rows, F] and part [slots,
// F] float32. Needs n_rows >= n_dst, every source id < n_rows, every v <
// n_dst and F % min(F, 128) == 0.
int block_spmm_launch(const void* src, const void* val, const void* items,
                      long long n_items, const void* splits,
                      long long n_split, long long n_dst, const void* x,
                      int bf16, long long n_rows, int F, void* y, void* part,
                      void* stream) {
  if (n_rows <= 0 || F <= 0) return (int)cudaGetLastError();
  const int ft = F < kMaxFeatTile ? F : kMaxFeatTile;
  if (F % ft != 0 || F / ft > 65535 || n_rows < n_dst ||
      (n_items + (n_rows - n_dst) + kWarps - 1) / kWarps > 0x7fffffffLL ||
      (n_split + kWarps - 1) / kWarps > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_t<__nv_bfloat16>(src, val, items, n_items, splits,
                                   n_split, n_dst, x, n_rows, F, y, part, s);
  return launch_t<float>(src, val, items, n_items, splits, n_split, n_dst,
                         x, n_rows, F, y, part, s);
}

const char* block_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

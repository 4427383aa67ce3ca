// Fused degree-binned pull extension for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/binned_pull/binned_pull.py
// (fused_binned_pull, body _make_kernel): one bottom-up frontier
// extension over the degree-binned reverse slabs. For every live row r
// at padded binned position pos (r = perm_pad[pos]) and every lane l:
//
//   acc = reduce over the slots j of pos's slab row of
//           reach*       : max  gsrc[u, l]
//           min_parent*  : min  (gsrc[u, l] != 0 ? u : NO_PARENT)
//           min_dist     : min  gsrc[u] + w[j]           (w = 1 if none)
//   out[r, l] = vloc[r, l] ? suppress : acc
//
// where u = slab[row, j] and an id u >= n_out (the slab sentinel) reads
// the op's source pad value by a bounds check, so no padded copy of gsrc
// exists. Rows of the zero-width bucket (positions < zero_rows) emit the
// neutral value. The un-permute and the visited suppression happen in the
// same pass: the kernel writes out[perm_pad[pos]] directly, and each live
// row is written exactly once (perm_pad is a bijection on live rows).
//
// What bounds it on an H100: bytes and latency, not arithmetic. One full
// pass reads every slab slot once (int32 ids), gathers one source byte
// (or lane row) per slot and writes one output per (row, lane); the
// reductions are a compare per slot. At the scale-10 LDBC proxy the
// slabs are ~10 MB, so the pass is a few microseconds of bandwidth and
// the launch itself dominates. The design keeps the gathers parallel:
//   * narrow slabs (width < 32): one thread per (row, lane), looping over
//     its few slots; threads of one row share the id reads;
//   * wide slabs (width >= 32): one 256-thread block per row, the slots
//     split over thread groups and a shared-memory tree reduction per
//     lane tile, so the 8 hub rows of width ~24K are not serialised on
//     one thread each;
//   * a (row, lane) that is already visited skips its gathers (it emits
//     the suppression value whatever it would gather), which is the TPU
//     kernel's bit-neutral tile skip at (row, lane) granularity.
// Every op is a max or a min (min_dist adds one weight before its min),
// so the result is bitwise independent of the reduction order.
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() after its launches.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int OP_REACH = 0;
constexpr int OP_REACH_LANES = 1;
constexpr int OP_MIN_PARENT = 2;
constexpr int OP_MIN_PARENT_LANES = 3;
constexpr int OP_MIN_DIST = 4;

constexpr int32_t NO_PARENT = 2147483647;
constexpr int WIDE = 32;        // first slab width served block-per-row
constexpr int WIDE_THREADS = 256;
constexpr int MAX_SLABS = 512;  // descriptor entries cached in shared mem

// one slab descriptor: int64 fields
// [0] slab ptr, [1] weight-slab ptr (0 = unit weights), [2] width,
// [3] rows_pad, [4] astart (first padded binned position)
struct Desc {
  long long slab, wslab, width, rows, astart;
};

template <int OP>
struct Op;

template <>
struct Op<OP_REACH> {
  using S = uint8_t;
  using T = uint8_t;
  __device__ static T neutral() { return 0; }
  __device__ static T suppress() { return 0; }
  __device__ static S pad() { return 0; }
  __device__ static T step(T acc, S got, int32_t, float) {
    return got > acc ? got : acc;
  }
  __device__ static T combine(T a, T b) { return a > b ? a : b; }
};
template <>
struct Op<OP_REACH_LANES> : Op<OP_REACH> {};

template <>
struct Op<OP_MIN_PARENT> {
  using S = uint8_t;
  using T = int32_t;
  __device__ static T neutral() { return NO_PARENT; }
  __device__ static T suppress() { return NO_PARENT; }
  __device__ static S pad() { return 0; }
  __device__ static T step(T acc, S got, int32_t u, float) {
    T c = got != 0 ? u : NO_PARENT;
    return c < acc ? c : acc;
  }
  __device__ static T combine(T a, T b) { return a < b ? a : b; }
};
template <>
struct Op<OP_MIN_PARENT_LANES> : Op<OP_MIN_PARENT> {};

template <>
struct Op<OP_MIN_DIST> {
  using S = float;
  using T = float;
  __device__ static T neutral() { return __int_as_float(0x7f800000); }
  __device__ static T suppress() { return neutral(); }  // never used
  __device__ static S pad() { return neutral(); }
  __device__ static T step(T acc, S got, int32_t, float w) {
    T c = got + w;
    return c < acc ? c : acc;
  }
  __device__ static T combine(T a, T b) { return a < b ? a : b; }
};

// index of the slab holding padded position pos (astart ascending)
__device__ int find_slab(const Desc* d, int n, long long pos) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    int mid = (lo + hi + 1) >> 1;
    if (d[mid].astart <= pos) lo = mid; else hi = mid - 1;
  }
  return lo;
}

template <int OP>
__global__ void narrow_kernel(const Desc* __restrict__ desc, int n_slabs,
                              int n_narrow, long long zero_rows,
                              long long a_split, const void* gsrc_v,
                              long long n_out, int lanes,
                              const int32_t* __restrict__ perm_pad,
                              long long rows_local,
                              const uint8_t* __restrict__ vloc,
                              void* out_v) {
  using S = typename Op<OP>::S;
  using T = typename Op<OP>::T;
  __shared__ Desc sd[MAX_SLABS];
  for (int i = threadIdx.x; i < n_narrow && i < MAX_SLABS; i += blockDim.x)
    sd[i] = desc[i];
  __syncthreads();
  const Desc* d = n_narrow <= MAX_SLABS ? sd : desc;

  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= a_split * lanes) return;
  long long pos = t / lanes;
  int lane = (int)(t - pos * lanes);
  int32_t r = perm_pad[pos];
  if (r < 0 || r >= rows_local) return;  // slab-padding position
  long long o = (long long)r * lanes + lane;
  T* out = static_cast<T*>(out_v);
  if (vloc != nullptr && vloc[o] != 0) {
    out[o] = Op<OP>::suppress();
    return;
  }
  T acc = Op<OP>::neutral();
  if (pos >= zero_rows && n_narrow > 0) {
    const Desc& s = d[find_slab(d, n_narrow, pos)];
    const int32_t* slab = reinterpret_cast<const int32_t*>(s.slab);
    const float* w = reinterpret_cast<const float*>(s.wslab);
    long long base = (pos - s.astart) * s.width;
    const S* gsrc = static_cast<const S*>(gsrc_v);
    for (long long j = 0; j < s.width; ++j) {
      int32_t u = slab[base + j];
      S got = (u >= 0 && u < n_out) ? gsrc[(long long)u * lanes + lane]
                                    : Op<OP>::pad();
      acc = Op<OP>::step(acc, got, u, w ? w[base + j] : 1.0f);
    }
  }
  out[o] = acc;
}

template <int OP>
__global__ void wide_kernel(const Desc* __restrict__ desc, int n_slabs,
                            int first_wide, long long a_split,
                            const void* gsrc_v, long long n_out, int lanes,
                            const int32_t* __restrict__ perm_pad,
                            long long rows_local,
                            const uint8_t* __restrict__ vloc, void* out_v) {
  using S = typename Op<OP>::S;
  using T = typename Op<OP>::T;
  __shared__ T red[WIDE_THREADS];
  long long pos = a_split + blockIdx.x;
  int32_t r = perm_pad[pos];
  if (r < 0 || r >= rows_local) return;  // whole block: padding row
  const Desc* wd = desc + first_wide;
  const Desc& s = wd[find_slab(wd, n_slabs - first_wide, pos)];
  const int32_t* slab = reinterpret_cast<const int32_t*>(s.slab);
  const float* w = reinterpret_cast<const float*>(s.wslab);
  const long long base = (pos - s.astart) * s.width;
  const S* gsrc = static_cast<const S*>(gsrc_v);
  T* out = static_cast<T*>(out_v);

  // lane tile: the largest power of two <= min(lanes, 32); thread groups
  // of that many lanes split the row's slots
  int lt = 1;
  while (lt * 2 <= lanes && lt * 2 <= 32) lt *= 2;
  const int groups = WIDE_THREADS / lt;
  const int li = threadIdx.x % lt;
  const int grp = threadIdx.x / lt;
  for (int l0 = 0; l0 < lanes; l0 += lt) {
    const int lane = l0 + li;
    const bool valid = lane < lanes;
    const long long o = (long long)r * lanes + lane;
    const bool vis = valid && vloc != nullptr && vloc[o] != 0;
    T acc = Op<OP>::neutral();
    if (valid && !vis) {
      for (long long j = grp; j < s.width; j += groups) {
        int32_t u = slab[base + j];
        S got = (u >= 0 && u < n_out) ? gsrc[(long long)u * lanes + lane]
                                      : Op<OP>::pad();
        acc = Op<OP>::step(acc, got, u, w ? w[base + j] : 1.0f);
      }
    }
    red[threadIdx.x] = acc;
    __syncthreads();
    for (int half = groups / 2; half > 0; half >>= 1) {
      if (grp < half)
        red[threadIdx.x] =
            Op<OP>::combine(red[threadIdx.x], red[threadIdx.x + half * lt]);
      __syncthreads();
    }
    if (grp == 0 && valid) out[o] = vis ? Op<OP>::suppress() : red[li];
    __syncthreads();
  }
}

template <int OP>
int launch(const Desc* desc, int n_slabs, int first_wide,
           long long zero_rows, long long a_split, long long rbp,
           const void* gsrc, long long n_out, int lanes,
           const int32_t* perm_pad, long long rows_local,
           const uint8_t* vloc, void* out, cudaStream_t stream) {
  long long narrow_threads = a_split * lanes;
  if (narrow_threads > 0) {
    const int threads = 256;
    long long blocks = (narrow_threads + threads - 1) / threads;
    narrow_kernel<OP><<<(unsigned)blocks, threads, 0, stream>>>(
        desc, n_slabs, first_wide, zero_rows, a_split, gsrc, n_out, lanes,
        perm_pad, rows_local, vloc, out);
  }
  long long wide_rows = rbp - a_split;
  if (wide_rows > 0) {
    wide_kernel<OP><<<(unsigned)wide_rows, WIDE_THREADS, 0, stream>>>(
        desc, n_slabs, first_wide, a_split, gsrc, n_out, lanes, perm_pad,
        rows_local, vloc, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// desc: device array [n_slabs] of Desc, slabs in ascending width;
// slabs [0, first_wide) have width < 32 and cover positions
// [zero_rows, a_split); slabs [first_wide, n_slabs) cover [a_split, rbp).
int binned_pull_launch(int op, const void* desc, int n_slabs,
                       int first_wide, long long zero_rows,
                       long long a_split, long long rbp, const void* gsrc,
                       long long n_out, int lanes, const void* perm_pad,
                       long long rows_local, const void* vloc, void* out,
                       void* stream) {
  const Desc* d = static_cast<const Desc*>(desc);
  const int32_t* pp = static_cast<const int32_t*>(perm_pad);
  const uint8_t* v = static_cast<const uint8_t*>(vloc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case OP_REACH:
      return launch<OP_REACH>(d, n_slabs, first_wide, zero_rows, a_split,
                              rbp, gsrc, n_out, lanes, pp, rows_local, v,
                              out, s);
    case OP_REACH_LANES:
      return launch<OP_REACH_LANES>(d, n_slabs, first_wide, zero_rows,
                                    a_split, rbp, gsrc, n_out, lanes, pp,
                                    rows_local, v, out, s);
    case OP_MIN_PARENT:
      return launch<OP_MIN_PARENT>(d, n_slabs, first_wide, zero_rows,
                                   a_split, rbp, gsrc, n_out, lanes, pp,
                                   rows_local, v, out, s);
    case OP_MIN_PARENT_LANES:
      return launch<OP_MIN_PARENT_LANES>(d, n_slabs, first_wide, zero_rows,
                                         a_split, rbp, gsrc, n_out, lanes,
                                         pp, rows_local, v, out, s);
    case OP_MIN_DIST:
      return launch<OP_MIN_DIST>(d, n_slabs, first_wide, zero_rows, a_split,
                                 rbp, gsrc, n_out, lanes, pp, rows_local, v,
                                 out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* binned_pull_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

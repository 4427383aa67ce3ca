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
// exists. Rows of the zero-width bucket emit the neutral value. The
// un-permute and the visited suppression happen in the same pass: the
// kernel writes out[perm_pad[pos]] directly, and each live row is
// written exactly once (perm_pad is a bijection on live rows).
//
// What bounds it on an H100: latency, then bytes; not arithmetic. A full
// pass reads each live row's slab slots once (int32 ids; 6.1 MB at the
// scale-10 LDBC proxy), gathers one source byte (or lane row) per slot
// and writes one output per (row, lane): a few microseconds of bandwidth,
// next to chains of dependent loads (task, perm_pad, vloc, id, source).
// The design keeps those chains short and the whole card busy in ONE
// launch over a work list built once per pack on the host (one Task per
// 256-thread block, hub chunks first so the longest blocks start first):
//   * rows below HUB_WIDTH (1,024): a power-of-two group of tpr threads
//     per row, at most a warp, so that each thread takes about ROW_SLOTS
//     (16, two rounds of loads) of its slots and a block's threads cover
//     many rows at once; a warp reads consecutive rows' slots, and a
//     shuffle combines a group. The lane ops give every such row a warp
//     whose threads take the lanes;
//   * hub rows: cut into chunks of CHUNK (4,096) slots, one block each;
//     the block's partial goes to a scratch slot, and the row's last
//     block to arrive (an atomic counter after a __threadfence) combines
//     the partials and writes the row; it resets the counter to 0, so
//     the counters are 0 between launches;
//   * every slot loop keeps UNROLL id loads, then UNROLL gathers, in
//     flight per thread. Fuller threads beat more of them: every wave
//     of blocks costs a whole chain of dependent loads, so the grid is
//     sized to about one wave at the scale-10 proxy (569 blocks);
//   * a visited (row, lane) skips its gathers, and a hub row whose lanes
//     are all visited skips its slab row altogether (chunk 0 writes it).
// Every op is a max or a min (min_dist adds one weight before its min),
// so partials combine in any order to the same bits: no float atomics.
// With L lanes, a row's threads take a tile of lt lanes (the largest
// power of two <= min(L, 32)) and split the slots among the rest.
//
// Launches on the caller's stream, allocates nothing (the scratch comes
// from the caller), and returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int OP_REACH = 0;
constexpr int OP_REACH_LANES = 1;
constexpr int OP_MIN_PARENT = 2;
constexpr int OP_MIN_PARENT_LANES = 3;
constexpr int OP_MIN_DIST = 4;

constexpr int32_t NO_PARENT = 2147483647;
constexpr int THREADS = 256;  // every block; BLOCK_THREADS in Python
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 8;
constexpr unsigned FULL = 0xffffffffu;

// one block's work, built by binned_pull.py::task_table (48 bytes)
struct Task {
  const int32_t* slab;  // first slot of the task (nullptr: zero width)
  const float* wslab;   // the same slot of the weight slab (nullptr: 1)
  int pos;              // first padded position (a hub chunk: its row's)
  int width;            // slots per row (a hub chunk: its own slots)
  int nrows;            // rows of the task; 0 marks a hub chunk
  int tpr;              // threads per row at one lane (power of two)
  int chunk;            // hub chunk: its index in the row
  int nchunks;          // hub chunk: chunks of its row
  int part;             // hub chunk: the row's first partial slot
  int unused;
};
static_assert(sizeof(Task) == 48, "Task must match TASK_WORDS");

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

__device__ __forceinline__ uint8_t shfl_xor(uint8_t v, int off) {
  return (uint8_t)__shfl_xor_sync(FULL, (int)v, off);
}
__device__ __forceinline__ int32_t shfl_xor(int32_t v, int off) {
  return __shfl_xor_sync(FULL, v, off);
}
__device__ __forceinline__ float shfl_xor(float v, int off) {
  return __shfl_xor_sync(FULL, v, off);
}

struct Args {
  const void* gsrc;
  long long n_out;
  int lanes;
  int lt;  // lane tile: largest power of two <= min(lanes, 32)
  const int32_t* perm_pad;
  long long rows_local;
  const uint8_t* vloc;
  void* out;
  void* partials;  // [hub chunks, lanes] of T
  int* counters;   // [hub chunks], 0 between launches
};

// acc over the slots j = j0, j0 + stride, ... < n of one slab row, at
// lane `lane`: rounds of UNROLL id loads, then UNROLL gathers, all in
// flight together. A slot past the row's end reads as id -1, which
// gathers the op's pad value, and stepping with the pad value (weight
// 1) leaves every op's accumulator as it was, so the last round needs
// no second loop.
template <int OP>
__device__ __forceinline__ typename Op<OP>::T gather(
    const int32_t* __restrict__ slab, const float* __restrict__ w, int n,
    int j0, int stride, const Args& a, int lane, typename Op<OP>::T acc) {
  using S = typename Op<OP>::S;
  const S* __restrict__ gsrc = static_cast<const S*>(a.gsrc);
  for (int j = j0; j < n; j += UNROLL * stride) {
    int32_t u[UNROLL];
    float wt[UNROLL];
    S got[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k)
      u[k] = j + k * stride < n ? __ldg(slab + j + k * stride) : -1;
#pragma unroll
    for (int k = 0; k < UNROLL; ++k)
      wt[k] = w != nullptr && j + k * stride < n ? __ldg(w + j + k * stride)
                                                 : 1.0f;
#pragma unroll
    for (int k = 0; k < UNROLL; ++k)
      got[k] = (u[k] >= 0 && u[k] < a.n_out)
                   ? __ldg(gsrc + (long long)u[k] * a.lanes + lane)
                   : Op<OP>::pad();
#pragma unroll
    for (int k = 0; k < UNROLL; ++k)
      acc = Op<OP>::step(acc, got[k], u[k], wt[k]);
  }
  return acc;
}

// narrow and warp rows: groups of g = max(tpr, lt) <= 32 threads, one
// row each; a group's lt lanes split its g / lt slot groups
template <int OP>
__device__ void rows_task(const Task& t, const Args& a) {
  using T = typename Op<OP>::T;
  T* out = static_cast<T*>(a.out);
  const int g = t.tpr > a.lt ? t.tpr : a.lt;
  const int sub = threadIdx.x % g;
  const int li = sub % a.lt;
  const int sg = sub / a.lt;
  const int groups = g / a.lt;
  const int per_pass = THREADS / g;
  for (int r0 = 0; r0 < t.nrows; r0 += per_pass) {  // uniform in the block
    const int k = r0 + threadIdx.x / g;
    int32_t r = -1;
    if (k < t.nrows) r = __ldg(a.perm_pad + t.pos + k);
    const bool live = r >= 0 && r < a.rows_local;
    const int32_t* srow = t.slab + (long long)k * t.width;
    const float* wrow = t.wslab ? t.wslab + (long long)k * t.width : nullptr;
    for (int l0 = 0; l0 < a.lanes; l0 += a.lt) {  // uniform as well
      const int lane = l0 + li;
      const bool act = live && lane < a.lanes;
      const long long o = (long long)r * a.lanes + lane;
      const bool vis = act && a.vloc != nullptr && a.vloc[o] != 0;
      T acc = Op<OP>::neutral();
      if (act && !vis && t.width > 0)
        acc = gather<OP>(srow, wrow, t.width, sg, groups, a, lane, acc);
      for (int off = a.lt; off < g; off <<= 1)
        acc = Op<OP>::combine(acc, shfl_xor(acc, off));
      if (act && sg == 0) out[o] = vis ? Op<OP>::suppress() : acc;
    }
  }
}

// one CHUNK of a hub row: the whole block splits the chunk's slots
template <int OP>
__device__ void hub_task(const Task& t, const Args& a) {
  using T = typename Op<OP>::T;
  __shared__ T red[WARPS][32];
  __shared__ int last;
  T* out = static_cast<T*>(a.out);
  T* part = static_cast<T*>(a.partials);
  const int32_t r = __ldg(a.perm_pad + t.pos);  // live by construction
  const long long base = (long long)r * a.lanes;
  bool all = a.vloc != nullptr;
  for (int l = threadIdx.x; all && l < a.lanes; l += THREADS)
    all = a.vloc[base + l] != 0;
  if (__syncthreads_and(all)) {  // the whole row is visited
    if (t.chunk == 0)
      for (int l = threadIdx.x; l < a.lanes; l += THREADS)
        out[base + l] = Op<OP>::suppress();
    return;
  }
  const int li = threadIdx.x % a.lt;
  const int grp = threadIdx.x / a.lt;
  const int warp = threadIdx.x / 32, wl = threadIdx.x % 32;
  const bool split = t.nchunks > 1;
  T* mine = part + (long long)(t.part + t.chunk) * a.lanes;
  for (int l0 = 0; l0 < a.lanes; l0 += a.lt) {
    const int lane = l0 + li;
    const bool act = lane < a.lanes;
    const bool vis = act && a.vloc != nullptr && a.vloc[base + lane] != 0;
    T acc = Op<OP>::neutral();
    if (act && !vis)
      acc = gather<OP>(t.slab, t.wslab, t.width, grp, THREADS / a.lt, a,
                       lane, acc);
    for (int off = a.lt; off < 32; off <<= 1)
      acc = Op<OP>::combine(acc, shfl_xor(acc, off));
    if (wl < a.lt) red[warp][wl] = acc;
    __syncthreads();
    if (threadIdx.x < a.lt && l0 + threadIdx.x < a.lanes) {
      T v = red[0][threadIdx.x];
#pragma unroll
      for (int k = 1; k < WARPS; ++k)
        v = Op<OP>::combine(v, red[k][threadIdx.x]);
      const int l = l0 + threadIdx.x;
      if (split) {
        mine[l] = v;
      } else {
        const bool vl = a.vloc != nullptr && a.vloc[base + l] != 0;
        out[base + l] = vl ? Op<OP>::suppress() : v;
      }
    }
    __syncthreads();
  }
  if (!split) return;
  // publish this chunk's partials; the row's last block combines them
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(a.counters + t.part, 1) == t.nchunks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int l = threadIdx.x; l < a.lanes; l += THREADS) {
    T v = Op<OP>::neutral();
    for (int c = 0; c < t.nchunks; ++c)
      v = Op<OP>::combine(
          v, __ldcg(part + (long long)(t.part + c) * a.lanes + l));
    const bool vl = a.vloc != nullptr && a.vloc[base + l] != 0;
    out[base + l] = vl ? Op<OP>::suppress() : v;
  }
  if (threadIdx.x == 0) a.counters[t.part] = 0;
}

template <int OP>
__global__ void __launch_bounds__(THREADS)
binned_pull_kernel(const Task* __restrict__ tasks, Args a) {
  const Task t = tasks[blockIdx.x];
  if (t.nrows == 0)
    hub_task<OP>(t, a);
  else
    rows_task<OP>(t, a);
}

template <int OP>
int launch(const Task* tasks, int n_tasks, const Args& a,
           cudaStream_t stream) {
  binned_pull_kernel<OP><<<(unsigned)n_tasks, THREADS, 0, stream>>>(tasks,
                                                                     a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// tasks: device array [n_tasks] of Task (binned_pull.py::task_table);
// partials: [hub chunks * lanes] 4-byte words of scratch; counters:
// [hub chunks] int32, zero between launches (each launch leaves them 0).
int binned_pull_launch(int op, const void* tasks, int n_tasks,
                       const void* gsrc, long long n_out, int lanes,
                       const void* perm_pad, long long rows_local,
                       const void* vloc, void* out, void* partials,
                       void* counters, void* stream) {
  if (n_tasks <= 0 || lanes <= 0) return 0;
  int lt = 1;
  while (lt * 2 <= lanes && lt * 2 <= 32) lt *= 2;
  Args a{gsrc, n_out, lanes, lt, static_cast<const int32_t*>(perm_pad),
         rows_local, static_cast<const uint8_t*>(vloc), out, partials,
         static_cast<int*>(counters)};
  const Task* t = static_cast<const Task*>(tasks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case OP_REACH: return launch<OP_REACH>(t, n_tasks, a, s);
    case OP_REACH_LANES: return launch<OP_REACH_LANES>(t, n_tasks, a, s);
    case OP_MIN_PARENT: return launch<OP_MIN_PARENT>(t, n_tasks, a, s);
    case OP_MIN_PARENT_LANES:
      return launch<OP_MIN_PARENT_LANES>(t, n_tasks, a, s);
    case OP_MIN_DIST: return launch<OP_MIN_DIST>(t, n_tasks, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* binned_pull_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

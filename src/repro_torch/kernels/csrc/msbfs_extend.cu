// MS-BFS block extension for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/msbfs_extend/msbfs_extend.py
// (msbfs_extend_blocks, body _kernel), which runs (A_block^T . F_stripe)
// > 0 on the MXU in int8 and ORs it into the destination lane tile. The
// port computes the same Boolean product directly on bits:
//
//   out[col*B + v][w] |= OR over u with A[u, v] != 0 of F[row*B + u][w]
//
// for every stored B x B tile (row, col) and every 64-lane word w, where
// F holds each source row's lanes bit-packed into uint64 words (lane l is
// bit l % 64 of word l / 64). A tile whose destination col is out of
// range (the ShardedBlocks pad sentinel G) is dropped, and a tile whose
// source stripe holds no frontier bit is skipped before its 16 KB of
// adjacency is read (the TPU kernel's activity skip). Results land with
// atomicOr, so tiles may come in any order: the col-sorted KernelBlocks
// and the row-sorted ShardedBlocks both work. Exact by construction.
//
// What bounds it on an H100: bytes. A full pass reads every stored tile
// once (B*B int8 = 16 KB each; 2.01 GB for the scale-10 LDBC proxy, about
// 0.6 ms at 3.35 TB/s) plus one 1 KB stripe of frontier words per tile;
// the OR work is one predicated OR per adjacency byte, far below the
// card's integer rate. One 128-thread block handles one (tile, word):
// the stripe's words go to shared memory, thread v walks column v of the
// tile (coalesced across threads for each source row u), and the stripe
// test lets inactive tiles return after 1 KB. A tensor-core (int8 wgmma)
// design is later work.
//
// Launches on the caller's stream, allocates nothing (the caller zeroes
// the output words), and returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void extend_kernel(const int8_t* __restrict__ blocks,
                              const int32_t* __restrict__ rows,
                              const int32_t* __restrict__ cols, int B,
                              const unsigned long long* __restrict__ fwords,
                              long long g_in, int words,
                              unsigned long long* __restrict__ out,
                              long long g_out) {
  extern __shared__ unsigned long long stripe[];
  const long long i = blockIdx.x;
  const int w = blockIdx.y;
  const int v = threadIdx.x;
  const int32_t col = cols[i];
  const int32_t row = rows[i];
  if (col < 0 || col >= g_out || row < 0 || row >= g_in) return;
  const unsigned long long f =
      fwords[((long long)row * B + v) * words + w];
  stripe[v] = f;
  if (!__syncthreads_or(f != 0ull)) return;  // inactive source stripe
  const int8_t* a = blocks + i * (long long)B * B;
  unsigned long long acc = 0ull;
  for (int u = 0; u < B; ++u) {
    if (a[(long long)u * B + v] != 0) acc |= stripe[u];
  }
  if (acc != 0ull) atomicOr(&out[((long long)col * B + v) * words + w], acc);
}

}  // namespace

extern "C" {

// blocks [nb, B, B] int8, rows/cols [nb] int32, fwords [g_in*B, words]
// uint64, out [g_out*B, words] uint64 (zeroed by the caller). B is the
// tile size and the block width (B <= 1024).
int msbfs_extend_launch(const void* blocks, const void* rows,
                        const void* cols, long long nb, int B,
                        const void* fwords, long long g_in, int words,
                        void* out, long long g_out, void* stream) {
  if (nb <= 0 || words <= 0) return (int)cudaGetLastError();
  if (B <= 0 || B > 1024 || words > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)nb, (unsigned)words);
  extend_kernel<<<grid, B, B * sizeof(unsigned long long),
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(blocks), static_cast<const int32_t*>(rows),
      static_cast<const int32_t*>(cols), B,
      static_cast<const unsigned long long*>(fwords), g_in, words,
      static_cast<unsigned long long*>(out), g_out);
  return (int)cudaGetLastError();
}

const char* msbfs_extend_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Flash-attention forward for Hopper (sm_90a), causal or full.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/
// flash_attention.py:77 (flash_attention, body _kernel :28, pallas_call
// :97): o = softmax(q k^T / sqrt(D), masked) v over [B*H, S, D] in float32
// or bfloat16, with the TPU kernel's numerics: q upcast to float32 and
// scaled in float32, masked scores set to -1e30 (not -inf), a running max
// m, running sum l and float32 accumulator per row updated one K/V tile at
// a time (online softmax), the denominator clamped at 1e-30 and the output
// rounded once to the input type.
//
// What bounds it on an H100: operations. At MiniCPM-2B's width (B 1, H 36,
// S 4096, D 64, causal, bf16) the two products are 7.73e10 operations,
// 0.078 ms at the 989 TFLOP/s bf16 tensor-core rate, against 75.5 MB of q,
// k, v and o (0.023 ms at 3.35 TB/s). This first kernel is simple and
// exact to float32 instead: both products are float32 FMAs on the CUDA
// cores (67 TFLOP/s at best), so it stays well above that bound; a
// tensor-core (mma.sync / wgmma with TMA) design is later work.
//
// The TPU kernel carries m, l and acc in VMEM across a sequential grid of
// K/V blocks. Here one CTA of 256 threads owns one (batch*head, 64-row q
// tile) and loops over the 64-key K/V tiles itself, up to the diagonal
// when causal, staging each tile in shared memory as float32 (zero-padded
// to DMAX in {32, 64, 128, 256} >= D). Thread (ty, tx) of a 16 x 16 grid
// holds rows 4*ty..4*ty+3: it computes their scores against keys tx,
// tx+16, tx+32, tx+48, reduces the row max and sum over the 16 threads of
// the row with shuffles, and accumulates output columns tx, tx+16, ... of
// its rows in registers. Rows are padded by one float in shared memory so
// that the 16 key rows a warp reads fall in 16 banks. q tiles are taken
// from the last to the first, so that the longest causal tiles start first.
// Any S works (keys past S are masked like the causal ones); the launcher
// keeps the TPU kernel's check S % block == 0.
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBq = 64;
constexpr int kBk = 64;
constexpr int kThreads = 256;
constexpr int kRows = 4;  // q rows per thread
constexpr int kCols = 4;  // keys per thread and tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int DMAX>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((kBq + 2 * kBk) * (DMAX + 1) + kBq * (kBk + 1));
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int S, int D,
              float scale, int causal) {
  constexpr int LD = DMAX + 1;
  constexpr int LP = kBk + 1;
  constexpr int DPT = DMAX / 16;  // output columns per thread
  extern __shared__ float sm[];
  float* qs = sm;             // [kBq][LD], scaled q
  float* ks = qs + kBq * LD;  // [kBk][LD]
  float* vs = ks + kBk * LD;  // [kBk][LD]
  float* ps = vs + kBk * LD;  // [kBq][LP], probabilities of the tile
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const long long base = (long long)blockIdx.x * S * D;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBq;

  for (int i = tid; i < kBq * DMAX; i += kThreads) {
    const int r = i / DMAX, d = i % DMAX;
    float val = 0.f;
    if (d < D && q0 + r < S)
      val = to_f32(q[base + (long long)(q0 + r) * D + d]) * scale;
    qs[r * LD + d] = val;
  }
  float m[kRows], l[kRows], acc[kRows][DPT];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }
  const int k_end = causal ? min(S, q0 + kBq) : S;
  for (int k0 = 0; k0 < k_end; k0 += kBk) {
    __syncthreads();  // the previous tile's ks, vs and ps are consumed
    for (int i = tid; i < kBk * DMAX; i += kThreads) {
      const int r = i / DMAX, d = i % DMAX;
      float kv = 0.f, vv = 0.f;
      if (d < D && k0 + r < S) {
        const long long at = base + (long long)(k0 + r) * D + d;
        kv = to_f32(k[at]);
        vv = to_f32(v[at]);
      }
      ks[r * LD + d] = kv;
      vs[r * LD + d] = vv;
    }
    __syncthreads();
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[kRows], b[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = qs[(kRows * ty + i) * LD + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) b[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + kRows * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = k0 + tx + 16 * j;
        if (col >= S || (causal && col > row)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[(kRows * ty + i) * LP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kBk; ++c) {
      float p[kRows], b[DPT];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = ps[(kRows * ty + i) * LP + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) b[j] = vs[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(p[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + kRows * ty + i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 16 * j;
      if (d < D) store(&o[base + (long long)row * D + d], acc[i][j] / denom);
    }
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* o,
           long long bh, int S, int D, float scale, int causal,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DMAX>();
  auto kern = flash_fwd<T, DMAX>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((unsigned)bh, (unsigned)((S + kBq - 1) / kBq));
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, D, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o,
             long long bh, int S, int D, float scale, int causal,
             cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 32>(q, k, v, o, bh, S, D, scale, causal, stream);
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, bh, S, D, scale, causal, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, o, bh, S, D, scale, causal, stream);
  return launch<T, 256>(q, k, v, o, bh, S, D, scale, causal, stream);
}

}  // namespace

extern "C" {

// q, k, v, o [bh, S, D] contiguous, float32 or (is_bf16) bfloat16;
// 1 <= D <= 256; scale is the float32 value of 1/sqrt(D).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int is_bf16, long long bh, int S, int D,
                           float scale, int causal, void* stream) {
  if (bh <= 0 || S <= 0) return (int)cudaGetLastError();
  if (D <= 0 || D > 256 || bh > 0x7fffffffLL ||
      (S + kBq - 1) / kBq > 65535)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_d<__nv_bfloat16>(q, k, v, o, bh, S, D, scale, causal, s);
  return launch_d<float>(q, k, v, o, bh, S, D, scale, causal, s);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

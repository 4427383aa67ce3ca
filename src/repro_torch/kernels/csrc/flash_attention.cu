// Flash-attention forward for Hopper (sm_90a), causal or full.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/
// flash_attention.py:77 (flash_attention, body _kernel :28, pallas_call
// :97): o = softmax(q k^T / sqrt(D), masked) v over [B*H, S, D] in float32
// or bfloat16, with the TPU kernel's numerics: masked scores set to -1e30
// (not -inf), a running max m, running sum l and float32 accumulator per
// row updated one K/V tile at a time (online softmax), the denominator
// clamped at 1e-30 and the output rounded once to the input type. The
// TPU kernel carries m, l and acc in VMEM across a sequential grid of K/V
// blocks; here one CTA owns a block of q rows of one (batch*head) and loops
// over the K/V tiles itself, up to the diagonal when causal. q tiles are
// taken from the last to the first, so that the longest causal tiles start
// first. Two kernels, picked by the launcher by dtype:
//
// bfloat16: tensor cores (flash_fwd_bf16). What bounds it on an H100:
// operations. At MiniCPM-2B's width (B 1, H 36, S 4096, D 64, causal) the
// two products are 7.73e10 operations, 0.078 ms at the 989 TFLOP/s bf16
// tensor-core rate, against 75.5 MB of q, k, v and o (0.023 ms at 3.35
// TB/s). Only wgmma reaches that rate, so the design is Hopper's:
//   - one CTA owns 64 q rows per consumer warpgroup (three for the D tile
//     64, two otherwise) and has one producer warpgroup, of which one
//     thread issues the copies (setmaxnreg moves registers from it to the
//     consumers);
//   - the producer loads the q tile once, then keeps K/V tiles of 64 keys
//     in flight through a shared-memory ring of 4 stages (2 for the D tile
//     256, all that fit) with TMA (tensor maps made on the host through
//     cudaGetDriverEntryPoint, so the library needs no -lcuda), a full and
//     an empty mbarrier per stage; tiles above the causal diagonal are
//     never loaded;
//   - tiles are stored as 64-column panels (128 bytes a row) in TMA's
//     128-byte swizzle, the layout the wgmma descriptors name: q and K
//     K-major, V MN-major (transposed by the descriptor, not by a copy);
//   - S = q K^T on wgmma.m64n64k16 (bf16 in, float32 accumulators); the
//     online softmax runs on the accumulator fragments, row max and sum
//     over the 4 lanes of a quad by shuffles, ex2.approx with scale *
//     log2(e) folded into one FMA; masking (-1e30 on the raw score) only
//     where a tile crosses the diagonal or S;
//   - P is split in registers into two bf16 terms, P_hi = bf16(P) and
//     P_lo = bf16(P - P_hi), both fed to wgmma as A operands from
//     registers for O += P_hi V + P_lo V (O in float32 registers);
//   - each warpgroup runs S, softmax and P V of a tile in turn, and the
//     two warpgroups overlap each other (FlashAttention-3's pipelining
//     inside a warpgroup, S of the next tile issued beside P V, was slower
//     on the card at the MiniCPM shape, as were 128-key tiles for D 64);
//   - the epilogue divides by max(l, 1e-30) and rounds once to bf16.
// Head dims: D tiles of 64, 128 and 256, zero-filled past D by TMA (any D
// in 1..256; the launcher pads rows to a multiple of 8 elements when TMA's
// 16-byte stride rule needs it; the scale stays that of the true D).
// Numerics: JAX's -1e30 mask, 1e-30 clamp and one output rounding; q k is
// summed on the tensor cores and then scaled, where JAX scales q first.
// The tensor cores take P in bf16. P rounded once (relative error up to
// 2^-9 a weight) moves a row that averages two keys by up to 2^-11 of
// their V difference (0.003 for a difference of 6, as early causal rows
// of N(0, 1) inputs have), outside the bf16 band (rtol 2^-7, atol 1e-3
// of the float32 plain result), and it failed the card tests so, even
// with l summed from the rounded P. So P travels as P_hi + P_lo, whose
// error is about 2^-18 of P, at the cost of a second P V product (1.5x
// the tensor-core work); l is summed from P in float32.
//
// float32: CUDA cores (flash_fwd_f32), exact to float32: q upcast and
// scaled in float32, both products as float32 FMAs (67 TFLOP/s at best, so
// well above the operations bound; its 2e-5 band would not survive TF32).
// One CTA of 256 threads owns a 64-row q tile and loops over 64-key tiles
// staged in shared memory (zero-padded to DMAX in {32, 64, 128, 256} >=
// D). Thread (ty, tx) of a 16 x 16 grid holds rows 4*ty..4*ty+3: it
// computes their scores against keys tx, tx+16, tx+32, tx+48, reduces the
// row max and sum over the 16 threads of the row with shuffles, and
// accumulates output columns tx, tx+16, ... of its rows in registers. Rows
// are padded by one float in shared memory so that the 16 key rows a warp
// reads fall in 16 banks.
//
// Any S works (keys past S are masked like the causal ones); the launcher
// keeps the TPU kernel's check S % block == 0. Both launch on the caller's
// stream, allocate nothing, and return cudaGetLastError() after the launch
// (a tensor-map failure returns cudaErrorInvalidValue, a missing driver
// entry point cudaErrorNotSupported).

#include <cuda.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;

// ---- float32: CUDA-core kernel ---------------------------------------------

constexpr int kBq = 64;
constexpr int kBk = 64;
constexpr int kThreads = 256;
constexpr int kRows = 4;  // q rows per thread
constexpr int kCols = 4;  // keys per thread and tile

template <int DMAX>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((kBq + 2 * kBk) * (DMAX + 1) + kBq * (kBk + 1));
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int S,
                  int D, float scale, int causal) {
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
      val = q[base + (long long)(q0 + r) * D + d] * scale;
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
        kv = k[at];
        vv = v[at];
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
      if (d < D) o[base + (long long)row * D + d] = acc[i][j] / denom;
    }
  }
}


template <int DMAX>
int launch_f32(const float* q, const float* k, const float* v, float* o,
               long long bh, int S, int D, float scale, int causal,
               cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DMAX>();
  auto kern = flash_fwd_f32<DMAX>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((unsigned)bh, (unsigned)((S + kBq - 1) / kBq));
  kern<<<grid, kThreads, smem, stream>>>(q, k, v, o, S, D, scale, causal);
  return (int)cudaGetLastError();
}

// ---- bfloat16: wgmma kernel ------------------------------------------------

constexpr int kPanel = 64;  // columns of a 128-byte swizzled panel
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed. A wait
// of about two seconds means a broken pipeline: trap, so that the launch
// fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 32)) __trap();
  } while (!done);
}

// One box of a 3-D tensor map (columns c0.., rows c1.., batch*head c2) into
// shared memory, completing `bytes` on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// byte offset (K-major: unused, 16; MN-major: the stride between 64-column
// panels) and stride byte offset (1024: eight 128-byte rows).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep reads of accumulators after the wait that completes them.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 2^x on the special-function unit (relative error about 2^-22).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 p) {
  return *reinterpret_cast<const uint32_t*>(&p);
}

template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  // D[64 x 64] = A . B (scale_d 0) or D += A . B (1); A and B in
  // shared memory, K-major
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }

  // D[64 x 64] += A (registers) . B (shared memory, MN-major)
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  // D[64 x 128] += A (registers) . B (shared memory, MN-major)
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// Tile shapes of the bf16 kernel for a D tile DT: consumer warpgroups (64
// q rows each) and the registers setmaxnreg gives them and the producer
// warpgroup (within the SM's 65,536), keys per K/V tile, ring stages, the
// product width N of one O instruction, and shared memory.
template <int DT>
struct Tc {
  static constexpr int kConsumers = DT == 64 ? 3 : 2;
  static constexpr int kRows = 64 * kConsumers;  // q rows per CTA
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kConsumerRegs = kConsumers == 3 ? 160 : 232;
  static constexpr int kProducerRegs = kConsumers == 3 ? 24 : 40;
  static constexpr int kPanels = DT / kPanel;
  static constexpr int kKeys = 64;
  static constexpr int kStages = DT <= 128 ? 4 : 2;
  static constexpr int kON = DT <= 128 ? DT : 128;  // O instruction N
  static constexpr int kOParts = DT / kON;
  static constexpr uint32_t kQBytes = kPanels * kRows * 128;
  static constexpr uint32_t kTileBytes = kPanels * kKeys * 128;  // K or V
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * kStages * kTileBytes + 8 * (1 + 2 * kStages);
};

// S = q K^T for one warpgroup (q rows at q_at, a K stage at k_at): D / 16
// wgmma steps of 16 columns, issued and committed, not waited for.
// The first step overwrites the accumulators (scale_d 0), so no other
// instruction writes them while products are in flight.
template <int DT>
__device__ __forceinline__ void issue_s(float (&sacc)[Tc<DT>::kKeys / 2],
                                       uint32_t q_at, uint32_t k_at) {
  constexpr int BK = Tc<DT>::kKeys;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < DT / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;  // bytes into the panel
    Wgmma<BK>::ss(sacc,
                  desc(q_at + (kk / 4) * Tc<DT>::kRows * 128 + col, 16),
                  desc(k_at + (kk / 4) * BK * 128 + col, 16), kk > 0);
  }
  wg_commit();
}

// O += P_hi V + P_lo V over BK / 16 steps of 16 keys (a V stage at v_at),
// issued and committed. V is MN-major: 16 keys are 16 rows of 128 bytes,
// panels BK * 128 bytes apart.
template <int DT>
__device__ __forceinline__ void issue_pv(
    float (&oacc)[Tc<DT>::kOParts][Tc<DT>::kON / 2],
    const uint32_t (&p_hi)[Tc<DT>::kKeys / 16][4],
    const uint32_t (&p_lo)[Tc<DT>::kKeys / 16][4], uint32_t v_at) {
  using C = Tc<DT>;
  constexpr int BK = C::kKeys;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int oh = 0; oh < C::kOParts; ++oh) {
      const uint64_t vd = desc(
          v_at + oh * (C::kON / kPanel) * BK * 128 + kk * 16 * 128, BK * 128);
      Wgmma<C::kON>::rs(oacc[oh], p_hi[kk], vd);
      Wgmma<C::kON>::rs(oacc[oh], p_lo[kk], vd);
    }
  wg_commit();
}

// The online softmax of one tile on its S fragments: sacc[4j + 2h + e] is
// row r0 + 8h, key k0 + 8j + c0 + e, in raw units (masked: -1e30); m is in
// log2 units (times c). Updates m and l, returns each row's factor for O
// in alpha, and P as P_hi + P_lo in the A-operand layout.
template <int DT>
__device__ __forceinline__ void softmax(
    float (&sacc)[Tc<DT>::kKeys / 2], uint32_t (&p_hi)[Tc<DT>::kKeys / 16][4],
    uint32_t (&p_lo)[Tc<DT>::kKeys / 16][4], float (&m)[2], float (&l)[2],
    float (&alpha)[2], int k0, int r0, bool mask, int S, int causal,
    float c) {
  constexpr int BK = Tc<DT>::kKeys;
  const int c0 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + c0 + e;
        if (mask && ((causal && key > row) || key >= S))
          sacc[4 * j + 2 * h + e] = kNegInf;
        mx = fmaxf(mx, sacc[4 * j + 2 * h + e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[h], mx * c);
    alpha[h] = ex2(m[h] - m_new);
    m[h] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float p0 = ex2(fmaf(sacc[4 * j + 2 * h], c, -m_new));
      const float p1 = ex2(fmaf(sacc[4 * j + 2 * h + 1], c, -m_new));
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      const float2 hf = __bfloat1622float2(hi);
      const __nv_bfloat162 lo =
          __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);  // exact diffs
      sum += p0 + p1;
      p_hi[j / 2][(j % 2) * 2 + h] = bits(hi);
      p_lo[j / 2][(j % 2) * 2 + h] = bits(lo);
    }
    l[h] = l[h] * alpha[h] + sum;
  }
}

template <int DT>
__device__ __forceinline__ void rescale(
    float (&oacc)[Tc<DT>::kOParts][Tc<DT>::kON / 2], const float (&alpha)[2]) {
#pragma unroll
  for (int oh = 0; oh < Tc<DT>::kOParts; ++oh)
#pragma unroll
    for (int i = 0; i < Tc<DT>::kON / 2; ++i)
      oacc[oh][i] *= alpha[(i / 2) % 2];
}

template <int DT>
__global__ void __launch_bounds__(Tc<DT>::kThreads, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ o, int S, int D, float scale,
                   int causal) {
  using C = Tc<DT>;
  constexpr int BK = C::kKeys;
  constexpr int kStages = C::kStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle atoms: 1024 B
  const uint32_t sq = base;
  const uint32_t sk = sq + C::kQBytes;  // [stage][panel][BK rows][128 B]
  const uint32_t sv = sk + kStages * C::kTileBytes;
  const uint32_t bars = sv + kStages * C::kTileBytes;
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8 + 8 * s; };
  auto empty = [&](int s) { return bars + 8 + 8 * kStages + 8 * s; };

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::kRows;
  const int k_end = causal ? min(S, q0 + C::kRows) : S;
  const int n_tiles = (k_end + BK - 1) / BK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), C::kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * C::kConsumers) {
    // producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
                     C::kProducerRegs)
                 : "memory");
    if (warp == 4 * C::kConsumers && lane == 0) {
      mbar_expect_tx(q_full, C::kQBytes);
      for (int p = 0; p < C::kPanels; ++p)
        tma_load(sq + p * C::kRows * 128, &tq, p * kPanel, q0, bh, q_full);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(empty(s), ((it / kStages) - 1) & 1);
        mbar_expect_tx(full(s), 2 * C::kTileBytes);
        for (int p = 0; p < C::kPanels; ++p) {
          const uint32_t off = s * C::kTileBytes + p * BK * 128;
          tma_load(sk + off, &tk, p * kPanel, it * BK, bh, full(s));
          tma_load(sv + off, &tv, p * kPanel, it * BK, bh, full(s));
        }
      }
    }
  } else {
    // consumer warpgroup: rows q0 + wrow .. +63; this thread holds rows r0
    // and r0 + 8 of them (accumulator fragment layout)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
                     C::kConsumerRegs)
                 : "memory");
    const int wrow = 64 * (warp >> 2);
    const int r0 = q0 + wrow + 16 * (warp & 3) + (lane >> 2);
    const float c = scale * kLog2e;
    // tiles from n_mine on hold keys above every row of this warpgroup
    const int n_mine =
        causal ? min(n_tiles, (q0 + wrow + 63) / BK + 1) : n_tiles;
    float oacc[C::kOParts][C::kON / 2];
#pragma unroll
    for (int h = 0; h < C::kOParts; ++h)
#pragma unroll
      for (int i = 0; i < C::kON / 2; ++i) oacc[h][i] = 0.f;
    float m[2] = {kNegInf, kNegInf};  // running max, times c (log2 units)
    float l[2] = {0.f, 0.f};  // this thread's share of the running sum
    float alpha[2];
    float sacc[BK / 2];
    uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
    mbar_wait(q_full, 0);
    for (int it = 0; it < n_mine; ++it) {
      const int s = it % kStages;
      const int k0 = it * BK;
      mbar_wait(full(s), (it / kStages) & 1);
      issue_s<DT>(sacc, sq + wrow * 128, sk + s * C::kTileBytes);
      wg_wait();
      fence_regs(sacc);
      const bool mask = (causal && k0 + BK - 1 > q0 + wrow) || k0 + BK > S;
      softmax<DT>(sacc, p_hi, p_lo, m, l, alpha, k0, r0, mask, S, causal,
                  c);
      rescale<DT>(oacc, alpha);
      issue_pv<DT>(oacc, p_hi, p_lo, sv + s * C::kTileBytes);
      wg_wait();
#pragma unroll
      for (int oh = 0; oh < C::kOParts; ++oh) fence_regs(oacc[oh]);
      mbar_arrive(empty(s));
    }
    for (int it = n_mine; it < n_tiles; ++it) {  // released, never read
      const int s = it % kStages;
      mbar_wait(full(s), (it / kStages) & 1);
      mbar_arrive(empty(s));
    }
    // epilogue: the row sums over the quad, then one rounding to bf16
    const int c0 = 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int row = r0 + 8 * h;
      if (row >= S) continue;
      const float denom = fmaxf(l[h], 1e-30f);
      __nv_bfloat16* orow = o + ((long long)bh * S + row) * D;
#pragma unroll
      for (int oh = 0; oh < C::kOParts; ++oh)
#pragma unroll
        for (int j = 0; j < C::kON / 8; ++j) {
          const int col = oh * C::kON + 8 * j + c0;
          const float a = oacc[oh][4 * j + 2 * h] / denom;
          const float b = oacc[oh][4 * j + 2 * h + 1] / denom;
          if (col + 1 < D && (D % 2) == 0) {
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(a, b);
          } else {
            if (col < D) orow[col] = __float2bfloat16(a);
            if (col + 1 < D) orow[col + 1] = __float2bfloat16(b);
          }
        }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [bh, S, dp] bf16 tensor as 64-column boxes of `rows` rows, 128-byte
// swizzle, zeros past its edges.
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr,
              long long bh, int S, int dp, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)dp, (cuuint64_t)S,
                              (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)dp * 2,
                                 (cuuint64_t)S * dp * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kPanel, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DT>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                long long bh, int S, int D, int dp, float scale, int causal,
                cudaStream_t stream) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!make_map(enc, &tq, q, bh, S, dp, Tc<DT>::kRows) ||
      !make_map(enc, &tk, k, bh, S, dp, Tc<DT>::kKeys) ||
      !make_map(enc, &tv, v, bh, S, dp, Tc<DT>::kKeys))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = Tc<DT>::kSmem;
  auto kern = flash_fwd_bf16<DT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)bh, (unsigned)((S + Tc<DT>::kRows - 1) / Tc<DT>::kRows));
  kern<<<grid, Tc<DT>::kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), S, D, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// float32 q, k, v, o [bh, S, D] contiguous; 1 <= D <= 256; scale is the
// float32 value of 1/sqrt(D).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, long long bh, int S, int D, float scale,
                           int causal, void* stream) {
  if (bh <= 0 || S <= 0) return (int)cudaGetLastError();
  if (D <= 0 || D > 256 || bh > 0x7fffffffLL ||
      (S + kBq - 1) / kBq > 65535)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto qf = static_cast<const float*>(q);
  auto kf = static_cast<const float*>(k);
  auto vf = static_cast<const float*>(v);
  auto of = static_cast<float*>(o);
  if (D <= 32)
    return launch_f32<32>(qf, kf, vf, of, bh, S, D, scale, causal, s);
  if (D <= 64)
    return launch_f32<64>(qf, kf, vf, of, bh, S, D, scale, causal, s);
  if (D <= 128)
    return launch_f32<128>(qf, kf, vf, of, bh, S, D, scale, causal, s);
  return launch_f32<256>(qf, kf, vf, of, bh, S, D, scale, causal, s);
}

// bfloat16 q, k, v [bh, S, dp] contiguous and 16-byte aligned, dp a
// multiple of 8 with D <= dp (columns past D zero), o [bh, S, D];
// 1 <= D <= 256; scale is the float32 value of 1/sqrt(D).
int flash_attention_bf16_launch(const void* q, const void* k, const void* v,
                                void* o, long long bh, int S, int D, int dp,
                                float scale, int causal, void* stream) {
  if (bh <= 0 || S <= 0) return (int)cudaGetLastError();
  if (D <= 0 || D > 256 || dp < D || dp > 256 || dp % 8 != 0 ||
      bh > 0x7fffffffLL || (S + 63) / 64 > 65535 ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dp <= 64)
    return launch_bf16<64>(q, k, v, o, bh, S, D, dp, scale, causal, s);
  if (dp <= 128)
    return launch_bf16<128>(q, k, v, o, bh, S, D, dp, scale, causal, s);
  return launch_bf16<256>(q, k, v, o, bh, S, D, dp, scale, causal, s);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Quantized GEMM with the fused requantization epilogue, for Hopper (sm_90a):
//
//   out[m, n] = requant( sum_k (a[m, k] - 128) * w[n, k] + oc[n] )      (u8)
//
// a is u8 [M, K] row-major, w is s8 [N, K] (K-major, the port's stored
// weight layout), oc is s32 [N] and already carries the zero-point
// correction, the +128 recentering term and the folded bias
// (ops/gemm_int8.py compute_offset(..., recentered=True)), ep is an f32 [N]
// epilogue vector.  Two entry points share one main loop:
//
// qgemm_u8s8 (B1), two float orders, one flag:
//
//   gemm order (Linear):  q = f32(acc + oc) * mult[n] + zp_c          ep = mult
//   conv order (Conv2d):  q = ((f32(acc + oc) * s_a) * s_w[n]) / s_c + zp_c
//                                                                     ep = s_w
//
// then clip to [0, 255], +0.5 under 'nearest', truncate, and either
// max(., zp_c) under relu, or the fused activation epilogue (gemm order): the
// code is dequantized, x = (code - zp_c) * s_c, the activation applied (the
// formulas of ops/functional.ACTIVATIONS: relu, relu6, hardsigmoid,
// hardswish, sigmoid and silu with expf, gelu as 0.5*x*erfcf(-x*sqrt(1/2)))
// and requantized, q = y / act_scale + act_zp (a true division), clip,
// +0.5 under 'nearest', truncate.
//
// qgemm_u8s8_vzp (B2), several weight heads merged along N with their own
// output grids: q = f32(acc + oc) * mult[n] + zp[n], clip, +0.5 under
// 'nearest', truncate; no relu, no act.
//
// Every float step is an explicitly rounded intrinsic
// (__fmul_rn / __fdiv_rn / __fadd_rn), and the file is built with
// --fmad=false, so no FMA contraction can move a code: the integer and
// ordered-float epilogues are bit-identical to the plain PyTorch versions
// and to the JAX reference.  erfcf and expf may differ from the CPU's libm
// by an ULP, which can move a code that sits on a truncation boundary.
//
// Replaces the TPU kernels int8inferenceengine_tpu/ops/gemm_int8.py
// ::_qgemm_kernel (launched by _qgemm_pallas_impl), held to qgemm_xla's exact
// erf epilogue rather than the Pallas kernel's rational _erf, and
// ::_qgemm_kernel_vzp (launched by _qgemm_pallas_vzp, used by qgemm_multi).
//
// What bounds it on an H100: at the AlexNet batch-100 shapes mostly the
// bytes.  conv1, conv2, conv5 (im2col operand included) and the classifier
// Linears need more time to move their operands at 3.35 TB/s than to
// multiply them at 1,979 int8 TOP/s; conv3 and conv4 sit just above the
// compute line (15.1 vs 13.8 us and 22.7 vs 19.8 us), and conv2 just below.
// At the decode shapes (M = 8) it is the weight bytes alone, and a 128-row
// tile wastes 120 of its rows.
// Design: int8 tensor cores through mma.sync m16n8k32 (s8 x s8 -> s32); a
// 128x128 output tile per block, K walked in 64-byte steps inside the block
// with a two-stage cp.async ring in shared memory (rows padded to 80 bytes so
// the fragment reads hit 32 distinct banks); eight warps, each 64x32, keep
// their accumulators in registers; the epilogue runs from registers.  u8
// activations are recentered to s8 in registers by XOR 0x80 on each packed
// word.  Ragged M/N/K are masked: out-of-range rows and the K tail are
// zero-filled in shared memory (a zero weight tap contributes nothing) and
// stores are bounds-checked.  A K that is not a multiple of 16 (AlexNet
// conv1: 363) or an unaligned base pointer takes a byte-wise loader instead
// of 16-byte cp.async.  wgmma, TMA, deeper pipelines, split-K for small M
// and persistence are later work.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int BM = 128;              // block tile rows (M)
constexpr int BN = 128;              // block tile columns (N)
constexpr int BK = 64;               // K bytes per pipeline stage
constexpr int LDS = BK + 16;         // padded shared-memory row, bytes
constexpr int NTHREADS = 256;        // 8 warps: 2 along M x 4 along N
constexpr int WARP_M = 64;
constexpr int WARP_N = 32;
constexpr int MI = WARP_M / 16;      // m16 fragments per warp
constexpr int NI = WARP_N / 8;       // n8 fragments per warp
constexpr int CHUNKS_PER_ROW = BK / 16;
constexpr int CHUNKS = BM * BK / 16 / NTHREADS;   // 16-byte chunks a thread loads per tile

static_assert(BM == BN, "one loader serves both operand tiles");
static_assert(CHUNKS * NTHREADS * 16 == BM * BK, "tile must split evenly");

struct Epilogue {
  const int32_t* oc;
  const float* ep;
  const float* zpv;    // per-column zero points (qgemm_u8s8_vzp), else null
  float s_a;
  float s_c;
  float zp_f;
  int zp;
  int conv_order;
  int relu;
  int nearest;
  int act;             // 0: none, else an ops/gemm_int8.KERNEL_ACTS id
  float act_scale;
  float act_zp;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// One 128-row x 64-byte tile of a row-major [rows, K] byte matrix into
// shared memory, zero-filling rows >= `rows` and columns >= K.
template <bool kVec>
__device__ __forceinline__ void load_tile(uint8_t (*dst)[LDS], const uint8_t* __restrict__ src,
                                          int rows, int K, int r0, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int c = tid + i * NTHREADS;
    const int r = c / CHUNKS_PER_ROW;
    const int kc = (c % CHUNKS_PER_ROW) * 16;
    const int gr = r0 + r;
    const int gk = k0 + kc;
    if (kVec) {
      // K % 16 == 0: a chunk is wholly inside or wholly outside the matrix.
      const bool ok = gr < rows && gk < K;
      const uint8_t* p = ok ? src + static_cast<size_t>(gr) * K + gk : src;
      cp_async16(&dst[r][kc], p, ok ? 16 : 0);
    } else {
      uint32_t v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t word = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int kk = gk + 4 * j + b;
          const uint32_t byte =
              (gr < rows && kk < K) ? src[static_cast<size_t>(gr) * K + kk] : 0u;
          word |= byte << (8 * b);
        }
        v[j] = word;
      }
      *reinterpret_cast<uint4*>(&dst[r][kc]) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

__device__ __forceinline__ uint32_t ld_shared32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int32_t (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float hard_sigmoid(float x) {
  return __fdiv_rn(fminf(fmaxf(__fadd_rn(x, 3.0f), 0.0f), 6.0f), 6.0f);
}

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// ops/gemm_int8.KERNEL_ACTS ids; formulas of ops/functional.ACTIVATIONS
__device__ __forceinline__ float apply_act(int act, float x) {
  switch (act) {
    case 1: return fmaxf(x, 0.0f);
    case 2: return fminf(fmaxf(x, 0.0f), 6.0f);
    case 3: return hard_sigmoid(x);
    case 4: return __fmul_rn(x, hard_sigmoid(x));
    case 5: return sigmoid(x);
    case 6: return __fmul_rn(x, sigmoid(x));
    default: return __fmul_rn(__fmul_rn(0.5f, x), erfcf(__fmul_rn(-x, 0.707106781186547524f)));
  }
}

__device__ __forceinline__ int clip_trunc(float q, int nearest) {
  q = fminf(fmaxf(q, 0.0f), 255.0f);
  if (nearest) q = __fadd_rn(q, 0.5f);
  return __float2int_rz(q);
}

// The epilogue a kernel instance is compiled with: B1's requant with its
// optional relu, B1's requant with the act epilogue, or B2's per-column zero
// point.  A template parameter, so that the plain B1 epilogue carries none of
// the act code.
enum EpilogueMode { kRequant, kAct, kVzp };

// zpn is the column's zero point under kVzp, unused otherwise
template <int kMode>
__device__ __forceinline__ uint8_t requant(int32_t acc, int32_t oc, float e, float zpn,
                                           const Epilogue& p) {
  // s32 wrap-around add, as the reference's int32 arrays do
  const int32_t c = static_cast<int32_t>(static_cast<uint32_t>(acc) + static_cast<uint32_t>(oc));
  const float x = __int2float_rn(c);
  if (kMode == kVzp) {
    return static_cast<uint8_t>(clip_trunc(__fadd_rn(__fmul_rn(x, e), zpn), p.nearest));
  }
  const float q = p.conv_order
                      ? __fadd_rn(__fdiv_rn(__fmul_rn(__fmul_rn(x, p.s_a), e), p.s_c), p.zp_f)
                      : __fadd_rn(__fmul_rn(x, e), p.zp_f);
  int qi = clip_trunc(q, p.nearest);
  if (kMode == kAct) {
    const float y = apply_act(p.act, __fmul_rn(__fsub_rn(__int2float_rn(qi), p.zp_f), p.s_c));
    qi = clip_trunc(__fadd_rn(__fdiv_rn(y, p.act_scale), p.act_zp), p.nearest);
  } else if (p.relu) {
    qi = max(qi, p.zp);
  }
  return static_cast<uint8_t>(qi);
}

template <bool kVec, int kMode>
__global__ void __launch_bounds__(NTHREADS)
qgemm_u8s8_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ w,
                  uint8_t* __restrict__ out, int M, int N, int K, Epilogue p) {
  __shared__ __align__(16) uint8_t sa[2][BM][LDS];
  __shared__ __align__(16) uint8_t sb[2][BN][LDS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;           // fragment row group
  const int t = lane & 3;            // thread in group
  const int wm = (warp >> 2) * WARP_M;
  const int wn = (warp & 3) * WARP_N;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  int32_t acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0;

  const int nk = (K + BK - 1) / BK;
  load_tile<kVec>(sa[0], a, M, K, m0, 0, tid);
  load_tile<kVec>(sb[0], w, N, K, n0, 0, tid);
  cp_async_commit();

  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      // The stage written here was last read in iteration kt-1, which ended
      // with __syncthreads().
      load_tile<kVec>(sa[cur ^ 1], a, M, K, m0, (kt + 1) * BK, tid);
      load_tile<kVec>(sb[cur ^ 1], w, N, K, n0, (kt + 1) * BK, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[MI][4];
      uint32_t bf[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        // A fragment (row-major 16x32): rows g and g+8, bytes 4t..4t+3 and
        // 16+4t..16+4t+3; XOR 0x80 maps each u8 byte to the s8 value a-128.
        const uint8_t* r = &sa[cur][wm + mi * 16 + g][ks + 4 * t];
        af[mi][0] = ld_shared32(r) ^ 0x80808080u;
        af[mi][1] = ld_shared32(r + 8 * LDS) ^ 0x80808080u;
        af[mi][2] = ld_shared32(r + 16) ^ 0x80808080u;
        af[mi][3] = ld_shared32(r + 8 * LDS + 16) ^ 0x80808080u;
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        // B fragment (column-major 32x8): column g, bytes 4t.. and 16+4t..
        const uint8_t* r = &sb[cur][wn + ni * 8 + g][ks + 4 * t];
        bf[ni][0] = ld_shared32(r);
        bf[ni][1] = ld_shared32(r + 16);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }

  // Accumulator fragment: element j sits at row g + 8*(j/2), column 2t + j%2.
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
#pragma unroll
    for (int jn = 0; jn < 2; ++jn) {
      const int n = n0 + wn + ni * 8 + 2 * t + jn;
      if (n >= N) continue;
      const int32_t ocn = p.oc[n];
      const float en = p.ep[n];
      const float zpn = kMode == kVzp ? p.zpv[n] : 0.0f;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
        for (int jm = 0; jm < 2; ++jm) {
          const int m = m0 + wm + mi * 16 + g + 8 * jm;
          if (m < M) {
            out[static_cast<size_t>(m) * N + n] = requant<kMode>(acc[mi][ni][2 * jm + jn], ocn, en, zpn, p);
          }
        }
      }
    }
  }
}

template <int kMode>
int launch(const void* a, const void* w, void* out, int M, int N, int K, const Epilogue& p,
           void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  const bool vec = K % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a8 = static_cast<const uint8_t*>(a);
  const auto* w8 = static_cast<const uint8_t*>(w);
  auto* o8 = static_cast<uint8_t*>(out);
  if (vec) {
    qgemm_u8s8_kernel<true, kMode><<<grid, NTHREADS, 0, s>>>(a8, w8, o8, M, N, K, p);
  } else {
    qgemm_u8s8_kernel<false, kMode><<<grid, NTHREADS, 0, s>>>(a8, w8, o8, M, N, K, p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() (0 when the launch
// was accepted).  Pointers are device pointers; the caller checks shapes,
// dtypes and contiguity.
extern "C" int qgemm_u8s8(const void* a, const void* w, const void* oc, const void* ep,
                          void* out, int M, int N, int K, float s_a, float s_c, int zp_c,
                          int conv_order, int relu, int nearest, int act, float act_scale,
                          float act_zp, void* stream) {
  const Epilogue p{static_cast<const int32_t*>(oc), static_cast<const float*>(ep), nullptr, s_a,
                   s_c, static_cast<float>(zp_c), zp_c, conv_order, relu, nearest, act,
                   act_scale, act_zp};
  return act ? launch<kAct>(a, w, out, M, N, K, p, stream)
             : launch<kRequant>(a, w, out, M, N, K, p, stream);
}

extern "C" int qgemm_u8s8_vzp(const void* a, const void* w, const void* oc, const void* mult,
                              const void* zp, void* out, int M, int N, int K, int nearest,
                              void* stream) {
  const Epilogue p{static_cast<const int32_t*>(oc), static_cast<const float*>(mult),
                   static_cast<const float*>(zp), 0.0f, 0.0f, 0.0f, 0, 0, 0, nearest, 0,
                   1.0f, 0.0f};
  return launch<kVzp>(a, w, out, M, N, K, p, stream);
}

// 4-bit grouped-weight GEMMs for Hopper (sm_90a): kernels B5, B6 and B7 of
// ops/w4.py.  Weights are packed nibbles, u8 [N, K/2] (high nibble = even k,
// low nibble = odd k, signed code = nibble - 8), with f32 group scales.
//
// w4a8_v2_gemm (B6; replaces int8inferenceengine_tpu/ops/w4.py
// ::_w4a8_kernel_v2, launched by _w4a8_pallas_impl_v2):
//
//   I_g[m, n] = sum_{k in group g} (x[m, k] - 128) * code[n, k]   exact s32
//   acc       = I_0 * s_0[n];  acc = acc + I_g * s_g[n]   (g = 1.., in order)
//   out[m, n] = floor(clip(acc * mult[n] + zpb_eff[n], 0, 255) + rb)     u8
//
// int8 tensor cores (mma.sync m16n8k32, s8 x s8 -> s32) on the recentred
// activations (x ^ 0x80 is the s8 value x - 128) and the unpacked s8 codes;
// one s32 accumulator per group, folded into the f32 sum at the group's end
// with __fmul_rn/__fadd_rn (|I_g| <= 128 * 7 * group < 2^24 for group <=
// 16384, so the conversion is exact).  Every float step is rounded on its
// own, so the result equals ops/w4.w4a8_v2_plain bit for bit.  The TPU
// kernel's three-dot packed-byte identity, its block-diagonal activation
// operand and its XOR bitcasts are MXU workarounds and are not carried over.
// Bound on an H100 at the decode shapes (M = 8): the packed weight bytes.
// Design: a 16 x 64 output tile per block of four warps (each 16 x 16), K in
// 64-value stages through a two-stage cp.async ring (x rows and packed rows,
// 16-byte chunks); the packed stage is unpacked to s8 codes in shared memory
// (two __byte_perm and a per-byte __vsub4 per word) before the MMAs.  A group
// is a multiple of 32 values (the MMA's k), K a multiple of the group.  M = 8
// fills half of the m16 tile; split-K, wgmma and TMA are later work.
//
// w4a8_v1_gemm (B7; replaces ::_w4a8_kernel, launched by _w4a8_pallas_impl)
// and w4_gemm (B5; replaces ::_w4_kernel, launched by _w4_pallas_impl) share
// one f32 SIMT main loop, the template's two instances:
//
//   B7: acc = sum_k (f32(x[m, k]) - zp_x) * (code * s_g)     (u8 x)
//       out = floor(clip(acc * mult[n] + zpb[n], 0, 255) + rb)          u8
//   B5: acc = sum_k x[m, k] * (code * s_g);  out = acc + bias[n]        f32
//
// The weight dequantizes as __fmul_rn(code, s), the JAX package's f32
// product; the dot accumulates with __fmaf_rn in true f32 (no TF32, no
// bf16).  Its sum order is its own: against the plain versions B7 is held to
// at most 1 code off on at most 0.2% of the outputs, B5 to 2e-5 of the
// largest |output|.  Bound on an H100 at the prefill shapes (M = 512): the
// f32 operations at the non-tensor-core peak.  Design: a 64 x 64 output tile
// per block of 256 threads, each 4 x 4 in registers, K in 16-value stages
// dequantized into shared memory; any M, N and even K, with a short last
// group.  Tensor cores (TF32 would change the function), double buffering
// and larger tiles are later work.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

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

__device__ __forceinline__ void mma_s8(int32_t (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// floor(clip(q, 0, 255) + rb) as a u8 code
__device__ __forceinline__ uint8_t clip_floor(float q, float rb) {
  q = fminf(fmaxf(q, 0.0f), 255.0f);
  return static_cast<uint8_t>(__float2int_rd(__fadd_rn(q, rb)));
}

// ---------------------------------------------------------------------------
// B6
// ---------------------------------------------------------------------------

namespace v2 {

constexpr int BM = 16;               // block tile rows (one m16 fragment)
constexpr int BN = 64;               // block tile columns
constexpr int BK = 64;               // k values per pipeline stage
constexpr int NT = 128;              // 4 warps, each 16 columns
constexpr int LD = BK + 16;          // padded x / code row, bytes
constexpr int PK = BK / 2;           // packed bytes per row and stage

__device__ __forceinline__ void load_stage(uint8_t (*xs)[LD], uint8_t (*ps)[PK],
                                           const uint8_t* __restrict__ x,
                                           const uint8_t* __restrict__ pk, int M, int N,
                                           int K, int m0, int n0, int k0, int tid) {
  // x: BM rows x 64 bytes = 64 chunks of 16 bytes
  if (tid < BM * BK / 16) {
    const int r = tid / (BK / 16);
    const int c = (tid % (BK / 16)) * 16;
    const bool ok = m0 + r < M && k0 + c < K;
    const uint8_t* p = ok ? x + static_cast<size_t>(m0 + r) * K + k0 + c : x;
    cp_async16(&xs[r][c], p, ok ? 16 : 0);
  }
  // packed weights: BN rows x 32 bytes = 128 chunks, one per thread; a chunk
  // holds 32 k values, and K % 32 == 0, so it is wholly inside or outside K
  {
    const int r = tid / 2;
    const int c = (tid % 2) * 16;
    const bool ok = n0 + r < N && k0 + 2 * c < K;
    const uint8_t* p = ok ? pk + static_cast<size_t>(n0 + r) * (K / 2) + k0 / 2 + c : pk;
    cp_async16(&ps[r][c], p, ok ? 16 : 0);
  }
}

// four packed bytes (eight k values) -> two words of s8 codes in k order
__device__ __forceinline__ void unpack8(uint32_t v, uint32_t& lo_word, uint32_t& hi_word) {
  const uint32_t h = (v >> 4) & 0x0F0F0F0Fu;    // even k
  const uint32_t l = v & 0x0F0F0F0Fu;           // odd k
  lo_word = __vsub4(__byte_perm(h, l, 0x5140), 0x08080808u);
  hi_word = __vsub4(__byte_perm(h, l, 0x7362), 0x08080808u);
}

__global__ void __launch_bounds__(NT)
w4a8_v2_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ pk,
               const float* __restrict__ sct, const float* __restrict__ mult,
               const float* __restrict__ zpb, uint8_t* __restrict__ out, int M, int N, int K,
               int group, float rb) {
  __shared__ __align__(16) uint8_t xs[2][BM][LD];
  __shared__ __align__(16) uint8_t ps[2][BN][PK];
  __shared__ __align__(16) uint8_t wc[BN][LD];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wn = warp * 16;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;

  int32_t acc[2][4];
  float accf[2][4];
#pragma unroll
  for (int ni = 0; ni < 2; ++ni)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[ni][j] = 0;
      accf[ni][j] = 0.0f;
    }

  const int nk = (K + BK - 1) / BK;
  load_stage(xs[0], ps[0], x, pk, M, N, K, m0, n0, 0, tid);
  cp_async_commit();

  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      load_stage(xs[cur ^ 1], ps[cur ^ 1], x, pk, M, N, K, m0, n0, (kt + 1) * BK, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    {
      // each thread unpacks one 16-byte chunk: row tid/2, 32 k values
      const int r = tid / 2;
      const int c = (tid % 2) * 16;
      const uint4 v = *reinterpret_cast<const uint4*>(&ps[cur][r][c]);
      uint32_t w[8];
      unpack8(v.x, w[0], w[1]);
      unpack8(v.y, w[2], w[3]);
      unpack8(v.z, w[4], w[5]);
      unpack8(v.w, w[6], w[7]);
      uint4* dst = reinterpret_cast<uint4*>(&wc[r][2 * c]);
      dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
      dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      const int kk = kt * BK + ks;
      if (kk >= K) break;
      uint32_t af[4];
      const uint8_t* ra = &xs[cur][g][ks + 4 * t];
      af[0] = *reinterpret_cast<const uint32_t*>(ra) ^ 0x80808080u;
      af[1] = *reinterpret_cast<const uint32_t*>(ra + 8 * LD) ^ 0x80808080u;
      af[2] = *reinterpret_cast<const uint32_t*>(ra + 16) ^ 0x80808080u;
      af[3] = *reinterpret_cast<const uint32_t*>(ra + 8 * LD + 16) ^ 0x80808080u;
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        const uint8_t* rb_ = &wc[wn + ni * 8 + g][ks + 4 * t];
        uint32_t bf[2];
        bf[0] = *reinterpret_cast<const uint32_t*>(rb_);
        bf[1] = *reinterpret_cast<const uint32_t*>(rb_ + 16);
        mma_s8(acc[ni], af, bf);
      }
      if ((kk + 32) % group == 0) {
        // the group ends here: fold its exact partial into the f32 sum
        const int gi = (kk + 32) / group - 1;
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = n0 + wn + ni * 8 + 2 * t + (j & 1);
            const float s = n < N ? sct[static_cast<size_t>(gi) * N + n] : 0.0f;
            const float term = __fmul_rn(__int2float_rn(acc[ni][j]), s);
            accf[ni][j] = gi == 0 ? term : __fadd_rn(accf[ni][j], term);
            acc[ni][j] = 0;
          }
        }
      }
    }
    // the stage read above is the one the next iteration's prefetch writes
    __syncthreads();
  }

  // accumulator element j: row g + 8 * (j / 2), column 2t + j % 2
#pragma unroll
  for (int ni = 0; ni < 2; ++ni) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + g + 8 * (j >> 1);
      const int n = n0 + wn + ni * 8 + 2 * t + (j & 1);
      if (m < M && n < N) {
        const float q = __fadd_rn(__fmul_rn(accf[ni][j], mult[n]), zpb[n]);
        out[static_cast<size_t>(m) * N + n] = clip_floor(q, rb);
      }
    }
  }
}

}  // namespace v2

// ---------------------------------------------------------------------------
// B5 and B7: one f32 SIMT main loop
// ---------------------------------------------------------------------------

namespace f32k {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int NT = 256;              // 16 x 16 threads, each 4 x 4 outputs
constexpr int TM = 4;
constexpr int TN = 4;

struct Params {
  const void* x;                     // u8 (B7) or f32 (B5) [M, K]
  const uint8_t* pk;                 // [N, K/2]
  const float* scales;               // [N, G], row-major
  const float* vec;                  // mult (B7) or bias (B5), [N]
  const float* zpb;                  // B7 only, [N]
  void* out;                         // u8 (B7) or f32 (B5) [M, N]
  int M, N, K, g, G;                 // g: the effective group, min(group, K)
  float zp_x;
  float rb;
};

template <bool kW4A8>
__global__ void __launch_bounds__(NT) w4_f32_kernel(Params p) {
  __shared__ __align__(16) float as[BK][BM];     // (x - zp_x), k-major
  __shared__ __align__(16) float bs[BK][BN];     // dequantized weight, k-major

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int M = p.M, N = p.N, K = p.K;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < BM * BK / NT; ++i) {
      const int idx = tid + i * NT;
      const int r = idx / BK;
      const int kk = idx % BK;
      const int m = m0 + r;
      const int k = k0 + kk;
      float v = 0.0f;
      if (m < M && k < K) {
        const size_t off = static_cast<size_t>(m) * K + k;
        v = kW4A8 ? __fsub_rn(__uint2float_rn(static_cast<const uint8_t*>(p.x)[off]), p.zp_x)
                  : static_cast<const float*>(p.x)[off];
      }
      as[kk][r] = v;
    }
#pragma unroll
    for (int i = 0; i < BN * BK / 2 / NT; ++i) {
      const int idx = tid + i * NT;
      const int r = idx / (BK / 2);
      const int j = idx % (BK / 2);
      const int n = n0 + r;
      const int k = k0 + 2 * j;                  // even; K even, so k + 1 < K
      float hi = 0.0f, lo = 0.0f;
      if (n < N && k < K) {
        const uint32_t b = p.pk[static_cast<size_t>(n) * (K / 2) + k / 2];
        const float* srow = p.scales + static_cast<size_t>(n) * p.G;
        hi = __fmul_rn(static_cast<float>(static_cast<int>(b >> 4) - 8), srow[k / p.g]);
        lo = __fmul_rn(static_cast<float>(static_cast<int>(b & 15u) - 8), srow[(k + 1) / p.g]);
      }
      bs[2 * j][r] = hi;
      bs[2 * j + 1][r] = lo;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&as[kk][ty * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&bs[kk][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n >= N) continue;
      const size_t o = static_cast<size_t>(m) * N + n;
      if (kW4A8) {
        const float q = __fadd_rn(__fmul_rn(acc[i][j], p.vec[n]), p.zpb[n]);
        static_cast<uint8_t*>(p.out)[o] = clip_floor(q, p.rb);
      } else {
        static_cast<float*>(p.out)[o] = __fadd_rn(acc[i][j], p.vec[n]);
      }
    }
  }
}

template <bool kW4A8>
int launch(const Params& p, void* stream) {
  if (p.M <= 0 || p.N <= 0 || p.K <= 0 || p.K % 2 || p.g <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM);
  w4_f32_kernel<kW4A8><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32k

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() (0 when the launch
// was accepted).  Pointers are device pointers; the caller (ops/w4.py) checks
// shapes, dtypes, contiguity and alignment.

extern "C" int w4a8_v2_gemm(const void* x, const void* packed, const void* scales_t,
                            const void* mult, const void* zpb_eff, void* out, int M, int N,
                            int K, int group, int nearest, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || group <= 0 || group % 32 || K % group ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(packed) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + v2::BN - 1) / v2::BN, (M + v2::BM - 1) / v2::BM);
  v2::w4a8_v2_kernel<<<grid, v2::NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scales_t), static_cast<const float*>(mult),
      static_cast<const float*>(zpb_eff), static_cast<uint8_t*>(out), M, N, K, group,
      nearest ? 0.5f : 0.0f);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int w4a8_v1_gemm(const void* x, const void* packed, const void* scales,
                            const void* mult, const void* zpb, void* out, int M, int N, int K,
                            int g, int zp_x, int nearest, void* stream) {
  const int G = g > 0 ? (K + g - 1) / g : 0;
  const f32k::Params p{x, static_cast<const uint8_t*>(packed), static_cast<const float*>(scales),
                       static_cast<const float*>(mult), static_cast<const float*>(zpb), out,
                       M, N, K, g, G, static_cast<float>(zp_x), nearest ? 0.5f : 0.0f};
  return f32k::launch<true>(p, stream);
}

extern "C" int w4_gemm(const void* x, const void* packed, const void* scales, const void* bias,
                       void* out, int M, int N, int K, int g, void* stream) {
  const int G = g > 0 ? (K + g - 1) / g : 0;
  const f32k::Params p{x, static_cast<const uint8_t*>(packed), static_cast<const float*>(scales),
                       static_cast<const float*>(bias), nullptr, out, M, N, K, g, G, 0.0f, 0.0f};
  return f32k::launch<false>(p, stream);
}

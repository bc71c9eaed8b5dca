// Quantized GEMM with the fused requantization epilogue, for Hopper (sm_90a):
//
//   out[m, n] = requant( sum_k (a[m, k] - 128) * w[n, k] + oc[n] )      (u8)
//
// a is u8 [M, K] row-major, w is s8 [N, K] (K-major, the port's stored
// weight layout), oc is s32 [N] and already carries the zero-point
// correction, the +128 recentering term and the folded bias
// (ops/gemm_int8.py compute_offset(..., recentered=True)), ep is an f32 [N]
// epilogue vector.  Three entry points share one main loop:
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
// hardswish, sigmoid and silu with exp, gelu as 0.5*x*erfc(-x*sqrt(1/2)))
// and requantized, q = y / act_scale + act_zp (a true division), clip,
// +0.5 under 'nearest', truncate.
//
// qgemm_u8s8_conv (B1, gathered): the same function with a[m, k] the im2col
// patch matrix of a u8 NHWC input, never written out.  Row m is the output
// pixel (b, oh, ow) and k = (l * kw + mm) * C + c, the patch order of
// ops/conv.im2col_nhwc; a tap outside the image reads the activation zero
// point, as the reference's padding does.  The gathered conv also has the
// bfloat16 conv epilogue (conv_order 2, QuantConfig.epilogue_dtype
// 'bfloat16'; ep = mult, bfloat16 values held in f32):
//
//   q = bf16(bf16(bf16(f32(acc + oc)) * mult[n]) + zp_c), clip to [0, 255],
//       + 0.5 rounded to bf16 under 'nearest', truncate, at most 255
//
// each op in float and rounded to bfloat16 nearest-even, as PyTorch's
// bfloat16 arithmetic and ops/quant.requant_bf16 do (a product of two
// bfloat16 values is exact in float, so it rounds as __hmul_rn would), and
// the s32 -> bfloat16 cast through float, as PyTorch's is.
//
// qgemm_u8s8_vzp (B2), several weight heads merged along N with their own
// output grids: q = f32(acc + oc) * mult[n] + zp[n], clip, +0.5 under
// 'nearest', truncate; no relu, no act.
//
// Every float step is an explicitly rounded intrinsic
// (__fmul_rn / __fdiv_rn / __fadd_rn), and the file is built with
// --fmad=false, so no FMA contraction can move a code: the integer and
// ordered-float epilogues are bit-identical to the plain PyTorch versions
// and to the JAX reference.  The act epilogue's exp and erfc run in double
// and round once to float, as ops/functional.rounded64 does: the correctly
// rounded float, where the card's and the CPU's float libms differ by an
// ULP, which moved a code on a truncation boundary.
//
// Replaces the TPU kernels int8inferenceengine_tpu/ops/gemm_int8.py
// ::_qgemm_kernel (launched by _qgemm_pallas_impl), held to qgemm_xla's exact
// erf epilogue rather than the Pallas kernel's rational _erf, and
// ::_qgemm_kernel_vzp (launched by _qgemm_pallas_vzp, used by qgemm_multi).
// The gathered conv is the counterpart of the JAX package's native integer
// conv (int8inferenceengine_tpu/ops/conv.py conv2d_int8_xla), which never
// materialises patches either.
//
// What bounds it on an H100: the AlexNet convolutions sit near the crossover
// of their bytes (the NHWC input read once) and their int8 operations at
// 1,979 TOP/s; the classifier Linears and every decode shape (M = 8) are
// bound by the weight bytes at 3.35 TB/s.
// Design: int8 tensor cores through mma.sync m16n8k32 (s8 x s8 -> s32) with
// fragments loaded by ldmatrix; u8 activations are recentered to s8 in
// registers by XOR 0x80 on each packed word.  K walks in 128-byte stages
// through a cp.async ring in dynamic shared memory (rows padded to 144 bytes,
// so that ldmatrix's eight row reads hit distinct banks), one barrier a
// stage.  The ops/gemm_int8.plan_qgemm planner picks, per launch, one of
// three tiles and a number of K slices:
//   tile 0: 128 x 128, eight warps of 64 x 32, a three-stage ring (two blocks
//           an SM) — large M, where the grid fills the card;
//   tile 1:  64 x  64, four warps of 32 x 32, four stages — between;
//   tile 2:  16 x  64, four warps of 16 x 16, four stages — M <= 16 (one
//           m16 fragment; decode), and M = 100 at N = 10.
// Where the tiles are fewer than the SMs, the planner cuts K into up to 8
// slices (each a multiple of the MMA's 32-value k) that run as one thread
// block cluster: every slice leaves its s32 partials in its own shared
// memory and slice 0 adds the others', in slice order, before the epilogue.
// s32 addition wraps and is associative, so any split gives the same codes.
// The epilogue stages the u8 tile in shared memory and stores 16-byte row
// runs.  Loads move 16-byte cp.async chunks where K (and C) allow, else
// 4-byte words, else bytes.  The gathered conv's loader keeps each output
// row's window origin in shared memory and finds its column's tap (l, mm)
// and channel c once a stage; where C % 16 == 0 a chunk lies inside one tap
// and is one cp.async from the image, or a 16-byte store of the replicated
// zero point where the tap is padding; where C % 4 == 0 the chunk is four
// 4-byte words, each inside one tap.  Other C are padded to a multiple of 4
// by the caller (AlexNet conv1: 3 -> 4).
// Four warps of 64 x 64 or a fourth stage at one block an SM measured
// slower on the convs (PERF.md); wgmma, TMA and persistence are later
// work.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int BK = 128;              // K bytes per pipeline stage
constexpr int LDS = BK + 16;         // padded shared-memory row, bytes
constexpr int CPR = BK / 16;         // 16-byte chunks per stage row
constexpr int KSTEP = 32;            // the MMA's k; a K slice is a multiple of it
constexpr int MAX_SLICES = 8;        // a portable cluster

// The three output tiles: rows x columns, warps along M x along N, ring
// stages and the blocks an SM holds.
template <int kTile>
struct Tile;
template <>
struct Tile<0> {
  static constexpr int BM = 128, BN = 128, WM = 2, WN = 4, STAGES = 3, BLOCKS = 2;
};
template <>
struct Tile<1> {
  static constexpr int BM = 64, BN = 64, WM = 2, WN = 2, STAGES = 4, BLOCKS = 3;
};
template <>
struct Tile<2> {
  static constexpr int BM = 16, BN = 64, WM = 1, WN = 4, STAGES = 4, BLOCKS = 4;
};

template <int kTile>
struct Shape : Tile<kTile> {
  using T = Tile<kTile>;
  static constexpr int NT = 32 * T::WM * T::WN;
  static constexpr int MI = T::BM / T::WM / 16;       // m16 fragments per warp
  static constexpr int NI = T::BN / T::WN / 8;        // n8 fragments per warp
  static constexpr int AI = T::BM * CPR / NT;         // A chunks a thread loads a stage
  static constexpr int WI = T::BN * CPR / NT;         // W chunks a thread loads a stage
  static constexpr int STAGE = (T::BM + T::BN) * LDS;
  static constexpr int RING = T::STAGES * STAGE;
  // + oc, ep, zp per column and the gathered conv's row table
  static constexpr int SMEM = RING + 12 * T::BN + 8 * T::BM;
  static_assert(AI >= 1 && WI >= 1 && T::BM * CPR % NT == 0 && T::BN * CPR % NT == 0 &&
                    NT % BK == 0 && T::BM * BK % NT == 0,
                "a stage must split evenly over the threads");
  static_assert(NI % 2 == 0, "B fragments load two n8 blocks per ldmatrix.x4");
  static_assert(T::BM * (T::BN + 16) <= RING, "the staged output tile fits the ring");
  static_assert(MI * NI * 4 * NT * 4 <= RING, "a slice's partials fit the ring");
};

struct Params {
  const uint8_t* a;    // gemm: u8 [M, K]; conv: u8 NHWC [B, H, W, C]
  const uint8_t* w;    // s8 [N, K]
  uint8_t* out;        // u8 [M, N]
  const int32_t* oc;
  const float* ep;
  const float* zpv;    // per-column zero points (qgemm_u8s8_vzp), else null
  int M, N, K;
  int kslice;          // K values per blockIdx.z slice (K when unsplit)
  // the gathered conv's input and window
  int H, W, C, kw, stride, pad, OH, OW;
  uint32_t zp4;        // the activation zero point in each byte
  // the epilogue
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const uint8_t* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s) : "memory");
}

__device__ __forceinline__ void mma_s8(int32_t (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---------------------------------------------------------------------------
// Loaders: one stage of A (BM rows) and W (BN rows), k values k0 .. k0+127,
// those at or past kend (the slice's end) zero-filled.  Three granularities
// (kLoad), the widest the operands allow:
//   kChunk16: K % 16 == 0 (and C % 16 == 0 for the conv), 16-byte aligned
//             bases: a 16-byte chunk is wholly inside or outside [0, kend)
//             and, for the conv, inside one tap; one cp.async each.
//   kWord4:   K % 4 == 0 (C % 4 == 0), 4-byte aligned bases: the chunk as
//             four 4-byte words, each inside one tap.
//   kByte:    anything else, a byte at a time.
// A thread loads 16-byte chunks (tid % 8) * 16 of rows tid / 8, + NT / 8,
// ...; the byte loader instead takes column tid % 128 of rows tid / 128,
// + NT / 128, ..., so that a warp reads 32 neighbouring bytes of one row.
// ---------------------------------------------------------------------------

enum LoadMode { kByte, kWord4, kChunk16 };

// A dense [rows, K] matrix (A of the GEMM, or W) of kChunks * NT / 8 rows
template <int kChunks, int NT, int kLoad>
__device__ __forceinline__ void load_dense(uint8_t* dst, const uint8_t* __restrict__ src,
                                           int rows, int K, int r0, int k0, int kend,
                                           int tid) {
  if (kLoad != kByte) {
    const int kc = (tid % CPR) * 16;
    const int gk = k0 + kc;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int r = tid / CPR + i * (NT / CPR);
      const int gr = r0 + r;
      const uint8_t* row = src + static_cast<size_t>(gr) * K;
      if (kLoad == kChunk16) {
        const bool ok = gr < rows && gk < kend;
        cp_async16(dst + r * LDS + kc, ok ? row + gk : src, ok ? 16 : 0);
      } else {
        uint32_t v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = gr < rows && gk + 4 * j < kend
                     ? *reinterpret_cast<const uint32_t*>(row + gk + 4 * j)
                     : 0u;
        *reinterpret_cast<uint4*>(dst + r * LDS + kc) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  } else {
    const int kc = tid % BK;
    const int gk = k0 + kc;
    // kChunks * NT / 8 rows, NT / 128 of them a pass
    constexpr int kPasses = kChunks * BK / CPR;
#pragma unroll 16
    for (int i = 0; i < kPasses; ++i) {
      const int r = tid / BK + i * (NT / BK);
      const int gr = r0 + r;
      dst[r * LDS + kc] =
          gr < rows && gk < kend ? src[static_cast<size_t>(gr) * K + gk] : uint8_t(0);
    }
  }
}

// The gathered conv's rows of the block, in shared memory: for output row
// m0 + r, the pixel index of the window's origin (b * H + ih0) * W + iw0,
// and ih0, iw0 packed as two 16-bit halves.  A row past M gets an origin far
// outside the image, so it reads the zero point (its output is never
// stored).
template <int BM, int NT>
__device__ __forceinline__ void conv_rows(int2* rows, const Params& p, int m0, int tid) {
  for (int r = tid; r < BM; r += NT) {
    const int m = m0 + r;
    int ih0 = -0x4000, iw0 = -0x4000, pix = 0;
    if (m < p.M) {
      const int ow = m % p.OW;
      const int t = m / p.OW;
      const int oh = t % p.OH;
      const int b = t / p.OH;
      ih0 = oh * p.stride - p.pad;
      iw0 = ow * p.stride - p.pad;
      pix = (b * p.H + ih0) * p.W + iw0;
    }
    rows[r] = make_int2(pix, static_cast<int>(static_cast<uint32_t>(ih0) << 16 | (iw0 & 0xFFFF)));
  }
}

// Is tap (l, mm) of the window at `row` inside the image?
__device__ __forceinline__ bool inside(int2 row, int l, int mm, const Params& p) {
  const int ih = (row.y >> 16) + l;
  const int iw = static_cast<int>(static_cast<int16_t>(row.y & 0xFFFF)) + mm;
  return static_cast<unsigned>(ih) < static_cast<unsigned>(p.H) &&
         static_cast<unsigned>(iw) < static_cast<unsigned>(p.W);
}

// A column of the patch matrix: its tap (l, mm), and its byte offset from
// the window's origin pixel in the NHWC image
struct Tap {
  int l, mm, off;
};

__device__ __forceinline__ Tap tap_of(int k, const Params& p) {
  const int tap = k / p.C;
  const int c = k - tap * p.C;
  const int l = tap / p.kw;
  const int mm = tap - l * p.kw;
  return Tap{l, mm, (l * p.W + mm) * p.C + c};
}

// The gathered A tile (C % 4 == 0; ops/conv.qgemm_conv pads other C): a
// thread's 16-byte chunks at column (tid % 8) * 16 of rows tid / 8, + NT / 8,
// ...  It finds its chunk's taps once a stage; a tap outside the image
// reads the replicated zero point.  kChunk16: the chunk lies inside one
// tap, one cp.async or a 16-byte store of the zero point.  kWord4: four
// 4-byte words, each inside one tap.  (A warp on one patch row's 128 bytes,
// whose loads coalesce, measured slower: PERF.md.)
template <int BM, int NT, int kLoad>
__device__ __forceinline__ void load_conv(uint8_t* dst, const Params& p, const int2* rows,
                                          int k0, int kend, int tid) {
  static_assert(kLoad != kByte, "a gathered conv moves 4-byte words at least");
  if (kLoad == kChunk16) {
    constexpr int kChunks = BM * CPR / NT;
    const int kc = (tid % CPR) * 16;
    const int gk = k0 + kc;
    const Tap tp = tap_of(gk, p);
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int r = tid / CPR + i * (NT / CPR);
      uint8_t* d = dst + r * LDS + kc;
      const int2 row = rows[r];
      if (gk >= kend) {
        cp_async16(d, p.a, 0);
      } else if (inside(row, tp.l, tp.mm, p)) {
        cp_async16(d, p.a + static_cast<size_t>(row.x) * p.C + tp.off, 16);
      } else {
        *reinterpret_cast<uint4*>(d) = make_uint4(p.zp4, p.zp4, p.zp4, p.zp4);
      }
    }
  } else {
    constexpr int kChunks = BM * CPR / NT;
    const int kc = (tid % CPR) * 16;
    const int gk = k0 + kc;
    Tap tp[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) tp[j] = tap_of(gk + 4 * j, p);
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int r = tid / CPR + i * (NT / CPR);
      const int2 row = rows[r];
      uint32_t v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = gk + 4 * j >= kend ? 0u
               : inside(row, tp[j].l, tp[j].mm, p)
                   ? *reinterpret_cast<const uint32_t*>(p.a + static_cast<size_t>(row.x) * p.C +
                                                        tp[j].off)
                   : p.zp4;
      *reinterpret_cast<uint4*>(dst + r * LDS + kc) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// The epilogue
// ---------------------------------------------------------------------------

__device__ __forceinline__ float hard_sigmoid(float x) {
  return __fdiv_rn(fminf(fmaxf(__fadd_rn(x, 3.0f), 0.0f), 6.0f), 6.0f);
}

// exp and erfc of a float in double, rounded once (ops/functional.rounded64)
__device__ __forceinline__ float exp64(float x) {
  return static_cast<float>(exp(static_cast<double>(x)));
}
__device__ __forceinline__ float erfc64(float x) {
  return static_cast<float>(erfc(static_cast<double>(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, exp64(-x)));
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
    default: return __fmul_rn(__fmul_rn(0.5f, x), erfc64(__fmul_rn(-x, 0.707106781186547524f)));
  }
}

__device__ __forceinline__ int clip_trunc(float q, int nearest) {
  q = fminf(fmaxf(q, 0.0f), 255.0f);
  if (nearest) q = __fadd_rn(q, 0.5f);
  return __float2int_rz(q);
}

// The epilogue a kernel instance is compiled with: B1's requant with its
// optional relu, B1's requant with the act epilogue, B2's per-column zero
// point, or B1's bfloat16 conv epilogue (gathered conv only).  A template
// parameter, so that the plain B1 epilogue carries none of the act code.
enum EpilogueMode { kRequant, kAct, kVzp, kBf16 };

// float -> the nearest-even bfloat16, back in float
__device__ __forceinline__ float bf16_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// zpn is the column's zero point under kVzp, unused otherwise
template <int kMode>
__device__ __forceinline__ uint32_t requant(int32_t acc, int32_t oc, float e, float zpn,
                                            const Params& p) {
  // s32 wrap-around add, as the reference's int32 arrays do
  const int32_t c = static_cast<int32_t>(static_cast<uint32_t>(acc) + static_cast<uint32_t>(oc));
  const float x = __int2float_rn(c);
  if (kMode == kVzp) {
    return static_cast<uint32_t>(clip_trunc(__fadd_rn(__fmul_rn(x, e), zpn), p.nearest));
  }
  if (kMode == kBf16) {
    // e is the bfloat16 multiplier; zp_f (an integer <= 255) and 0.5 are
    // exact in bfloat16
    float q = bf16_rn(__fadd_rn(bf16_rn(__fmul_rn(bf16_rn(x), e)), p.zp_f));
    q = fminf(fmaxf(q, 0.0f), 255.0f);
    if (p.nearest) q = bf16_rn(__fadd_rn(q, 0.5f));
    int qi = min(__float2int_rz(q), 255);  // 255.5 rounds to 256: saturate
    if (p.relu) qi = max(qi, p.zp);
    return static_cast<uint32_t>(qi);
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
  return static_cast<uint32_t>(qi);
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <int kTile, bool kConv, int kLoad, int kMode>
__global__ void __launch_bounds__(Shape<kTile>::NT, Tile<kTile>::BLOCKS)
qgemm_kernel(Params p) {
  using S = Shape<kTile>;
  constexpr int BM = S::BM, BN = S::BN, NT = S::NT, MI = S::MI, NI = S::NI;
  extern __shared__ __align__(128) uint8_t smem[];
  int32_t* v_oc = reinterpret_cast<int32_t*>(smem + S::RING);
  float* v_ep = reinterpret_cast<float*>(v_oc + BN);
  float* v_zp = v_ep + BN;
  int2* conv_row = reinterpret_cast<int2*>(v_zp + BN);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;           // fragment row group
  const int t = lane & 3;            // thread in group
  const int wm = warp / S::WN * (BM / S::WM);
  const int wn = warp % S::WN * (BN / S::WN);
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int kbeg = blockIdx.z * p.kslice;
  const int kend = min(kbeg + p.kslice, p.K);

  // the epilogue's per-column vectors, read after the main loop's barriers
  for (int i = tid; i < BN; i += NT) {
    const int n = n0 + i;
    const bool ok = n < p.N;
    v_oc[i] = ok ? p.oc[n] : 0;
    v_ep[i] = ok ? p.ep[n] : 0.0f;
    v_zp[i] = kMode == kVzp && ok ? p.zpv[n] : 0.0f;
  }

  if constexpr (kConv) {
    conv_rows<BM, NT>(conv_row, p, m0, tid);
    __syncthreads();
  }
  auto load_stage = [&](int slot, int k0) {
    uint8_t* sa = smem + slot * S::STAGE;
    if constexpr (kConv) {
      load_conv<BM, NT, kLoad>(sa, p, conv_row, k0, kend, tid);
    } else {
      load_dense<S::AI, NT, kLoad>(sa, p.a, p.M, p.K, m0, k0, kend, tid);
    }
    load_dense<S::WI, NT, kLoad>(sa + BM * LDS, p.w, p.N, p.K, n0, k0, kend, tid);
  };

  int32_t acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0;

  const int nk = (kend - kbeg + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < S::STAGES - 1; ++s) {
    if (s < nk) load_stage(s, kbeg + s * BK);
    cp_async_commit();
  }

  // ldmatrix row addresses of this lane: A 16 x 32 as four 8 x 16-byte
  // matrices (rows 0-7 | 8-15) x (bytes 0-15 | 16-31), giving a0..a3 of the
  // m16n8k32 fragment; B two n8 blocks x the two 16-byte halves of k
  const int a_row = wm + (lane & 15);
  const int a_col = (lane >> 4) * 16;
  const int b_row = wn + (lane & 7) + ((lane >> 4) << 3);
  const int b_col = ((lane >> 3) & 1) * 16;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<S::STAGES - 2>();
    // stage kt has landed for every thread, and every thread is done with
    // stage kt - 1, whose slot the prefetch below overwrites
    __syncthreads();
    const int pf = kt + S::STAGES - 1;
    if (pf < nk) load_stage(pf % S::STAGES, kbeg + pf * BK);
    cp_async_commit();

    const uint8_t* sa = smem + (kt % S::STAGES) * S::STAGE;
    const uint8_t* sb = sa + BM * LDS;
#pragma unroll
    for (int ks = 0; ks < BK; ks += KSTEP) {
      uint32_t af[MI][4];
      uint32_t bf[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        ldmatrix_x4(af[mi], sa + (a_row + mi * 16) * LDS + ks + a_col);
        // XOR 0x80 maps each u8 byte to the s8 value a - 128
#pragma unroll
        for (int j = 0; j < 4; ++j) af[mi][j] ^= 0x80808080u;
      }
#pragma unroll
      for (int nj = 0; nj < NI / 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4(r, sb + (b_row + nj * 16) * LDS + ks + b_col);
        bf[2 * nj][0] = r[0];
        bf[2 * nj][1] = r[1];
        bf[2 * nj + 1][0] = r[2];
        bf[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                   // the ring is free from here on

  if (gridDim.z > 1) {
    // K split over a thread block cluster: each slice leaves its partials in
    // its own shared memory, and slice 0 adds the others' to its own in
    // slice order (no atomics, no second launch)
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    int32_t* part = reinterpret_cast<int32_t*>(smem);
    const bool lead = cluster.block_rank() == 0;
    if (!lead) {
#pragma unroll
      for (int i = 0; i < MI * NI * 4; ++i)
        part[i * NT + tid] = acc[i / (NI * 4)][i / 4 % NI][i % 4];
    }
    cluster.sync();
    if (lead) {
      for (unsigned r = 1; r < gridDim.z; ++r) {
        const int32_t* other = cluster.map_shared_rank(part, r);
#pragma unroll
        for (int i = 0; i < MI * NI * 4; ++i) {
          int32_t& a = acc[i / (NI * 4)][i / 4 % NI][i % 4];
          a = static_cast<int32_t>(static_cast<uint32_t>(a) +
                                   static_cast<uint32_t>(other[i * NT + tid]));
        }
      }
    }
    // the other slices' shared memory stays readable until slice 0 is done
    cluster.sync();
    if (!lead) return;
  }

  // the u8 tile through shared memory, then out in 16-byte row runs.
  // Accumulator element j sits at row g + 8 * (j / 2), column 2t + j % 2.
  constexpr int LDO = BN + 16;
  uint8_t* tile = smem;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int col = wn + ni * 8 + 2 * t;
#pragma unroll
      for (int jm = 0; jm < 2; ++jm) {
        const uint32_t q0 = requant<kMode>(acc[mi][ni][2 * jm], v_oc[col], v_ep[col], v_zp[col], p);
        const uint32_t q1 =
            requant<kMode>(acc[mi][ni][2 * jm + 1], v_oc[col + 1], v_ep[col + 1], v_zp[col + 1], p);
        const int row = wm + mi * 16 + g + 8 * jm;
        *reinterpret_cast<uint16_t*>(&tile[row * LDO + col]) = static_cast<uint16_t>(q0 | q1 << 8);
      }
    }
  __syncthreads();
  const bool vec16 = p.N % 16 == 0 && reinterpret_cast<uintptr_t>(p.out) % 16 == 0;
  if (vec16) {
    for (int i = tid; i < BM * BN / 16; i += NT) {
      const int r = i / (BN / 16);
      const int c = i % (BN / 16) * 16;
      if (m0 + r < p.M && n0 + c < p.N)
        *reinterpret_cast<uint4*>(p.out + static_cast<size_t>(m0 + r) * p.N + n0 + c) =
            *reinterpret_cast<const uint4*>(&tile[r * LDO + c]);
    }
  } else {
    // neighbouring threads on neighbouring bytes
    for (int i = tid; i < BM * BN; i += NT) {
      const int r = i / BN;
      const int c = i % BN;
      if (m0 + r < p.M && n0 + c < p.N)
        p.out[static_cast<size_t>(m0 + r) * p.N + n0 + c] = tile[r * LDO + c];
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <int kTile, bool kConv, int kLoad, int kMode>
int launch_tile(const Params& p, int slices, cudaStream_t stream) {
  using S = Shape<kTile>;
  auto* kernel = qgemm_kernel<kTile, kConv, kLoad, kMode>;
  const dim3 grid((p.M + S::BM - 1) / S::BM, (p.N + S::BN - 1) / S::BN, slices);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // above 48 KB a kernel opts in to dynamic shared memory (on the current
  // device, so at every launch)
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (slices == 1) {
    kernel<<<grid, S::NT, S::SMEM, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = slices;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(S::NT);
  cfg.dynamicSmemBytes = S::SMEM;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, p);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <bool kConv, int kLoad, int kMode>
int launch_plan(const Params& p, int tile, int slices, cudaStream_t stream) {
  switch (tile) {
    case 0: return launch_tile<0, kConv, kLoad, kMode>(p, slices, stream);
    case 1: return launch_tile<1, kConv, kLoad, kMode>(p, slices, stream);
    case 2: return launch_tile<2, kConv, kLoad, kMode>(p, slices, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kConv, int kMode>
int launch_loader(const Params& p, int tile, int slices, int loader, cudaStream_t stream) {
  switch (loader) {
    case kByte:
      if constexpr (kConv) return static_cast<int>(cudaErrorInvalidValue);
      else return launch_plan<kConv, kByte, kMode>(p, tile, slices, stream);
    case kWord4: return launch_plan<kConv, kWord4, kMode>(p, tile, slices, stream);
    case kChunk16: return launch_plan<kConv, kChunk16, kMode>(p, tile, slices, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The plan (ops/gemm_int8.plan_qgemm) is checked, never adjusted: a plan
// this file cannot run is refused with cudaErrorInvalidValue.
template <int kMode>
int launch(Params p, bool conv, int tile, int slices, int kslice, int loader, void* stream) {
  if (p.M <= 0 || p.N <= 0 || p.K <= 0 || slices < 1 || slices > MAX_SLICES)
    return static_cast<int>(cudaErrorInvalidValue);
  if (slices == 1) {
    kslice = p.K;
  } else if (kslice <= 0 || kslice % KSTEP ||
             static_cast<long long>(kslice) * (slices - 1) >= p.K ||
             static_cast<long long>(kslice) * slices < p.K) {
    return static_cast<int>(cudaErrorInvalidValue);   // a slice empty or K uncovered
  }
  p.kslice = kslice;
  // the loader's granularity must divide K (and C) and both bases
  const int unit = loader == kChunk16 ? 16 : loader == kWord4 ? 4 : 1;
  if (reinterpret_cast<uintptr_t>(p.a) % unit || reinterpret_cast<uintptr_t>(p.w) % unit ||
      p.K % unit || (conv && p.C % unit))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (conv) {
    if constexpr (kMode == kRequant || kMode == kBf16)
      return launch_loader<true, kMode>(p, tile, slices, loader, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if constexpr (kMode == kBf16) return static_cast<int>(cudaErrorInvalidValue);
  else return launch_loader<false, kMode>(p, tile, slices, loader, s);
}

Params gemm_params(const void* a, const void* w, const void* oc, const void* ep, const void* zpv,
                   void* out, int M, int N, int K) {
  Params p{};
  p.a = static_cast<const uint8_t*>(a);
  p.w = static_cast<const uint8_t*>(w);
  p.out = static_cast<uint8_t*>(out);
  p.oc = static_cast<const int32_t*>(oc);
  p.ep = static_cast<const float*>(ep);
  p.zpv = static_cast<const float*>(zpv);
  p.M = M;
  p.N = N;
  p.K = K;
  p.act_scale = 1.0f;
  return p;
}

void set_requant(Params& p, float s_a, float s_c, int zp_c, int conv_order, int relu,
                 int nearest) {
  p.s_a = s_a;
  p.s_c = s_c;
  p.zp_f = static_cast<float>(zp_c);
  p.zp = zp_c;
  p.conv_order = conv_order;
  p.relu = relu;
  p.nearest = nearest;
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted).  Pointers are device pointers; the caller checks
// shapes, dtypes and contiguity.  tile, slices, kslice and loader are the
// plan of ops/gemm_int8.plan_qgemm: the tile index, the number of K slices
// (one cluster), the K values of each slice and the loader's granularity
// (0 bytes, 1 4-byte words, 2 16-byte cp.async).

extern "C" int qgemm_u8s8(const void* a, const void* w, const void* oc, const void* ep,
                          void* out, int M, int N, int K, float s_a, float s_c, int zp_c,
                          int conv_order, int relu, int nearest, int act, float act_scale,
                          float act_zp, int tile, int slices, int kslice, int loader,
                          void* stream) {
  // the bfloat16 epilogue (conv_order 2) is the gathered conv's alone
  if (conv_order < 0 || conv_order > 1) return static_cast<int>(cudaErrorInvalidValue);
  Params p = gemm_params(a, w, oc, ep, nullptr, out, M, N, K);
  set_requant(p, s_a, s_c, zp_c, conv_order, relu, nearest);
  p.act = act;
  p.act_scale = act_scale;
  p.act_zp = act_zp;
  return act ? launch<kAct>(p, false, tile, slices, kslice, loader, stream)
             : launch<kRequant>(p, false, tile, slices, kslice, loader, stream);
}

extern "C" int qgemm_u8s8_vzp(const void* a, const void* w, const void* oc, const void* mult,
                              const void* zp, void* out, int M, int N, int K, int nearest,
                              int tile, int slices, int kslice, int loader, void* stream) {
  Params p = gemm_params(a, w, oc, mult, zp, out, M, N, K);
  p.nearest = nearest;
  return launch<kVzp>(p, false, tile, slices, kslice, loader, stream);
}

// x is u8 NHWC [B, H, W, C] and w s8 [N, kh * kw * C]; out is u8 [B, OH, OW,
// N].  The input must hold fewer than 2^31 bytes, and H, W, pad < 2^14.
extern "C" int qgemm_u8s8_conv(const void* x, const void* w, const void* oc, const void* ep,
                               void* out, int B, int H, int W, int C, int kh, int kw,
                               int stride, int pad, int N, int zp_a, float s_a, float s_c,
                               int zp_c, int conv_order, int relu, int nearest, int tile,
                               int slices, int kslice, int loader, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || kh <= 0 || kw <= 0 || stride <= 0 || pad < 0 ||
      H + 2 * pad < kh || W + 2 * pad < kw || H >= (1 << 14) || W >= (1 << 14) ||
      pad >= (1 << 14) ||
      static_cast<long long>(B) * H * W * C >= (1LL << 31) || zp_a < 0 || zp_a > 255)
    return static_cast<int>(cudaErrorInvalidValue);
  const int OH = (H + 2 * pad - kh) / stride + 1;
  const int OW = (W + 2 * pad - kw) / stride + 1;
  const long long M = static_cast<long long>(B) * OH * OW;
  if (M >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  Params p = gemm_params(x, w, oc, ep, nullptr, out, static_cast<int>(M), N, kh * kw * C);
  set_requant(p, s_a, s_c, zp_c, conv_order, relu, nearest);
  p.H = H;
  p.W = W;
  p.C = C;
  p.kw = kw;
  p.stride = stride;
  p.pad = pad;
  p.OH = OH;
  p.OW = OW;
  p.zp4 = 0x01010101u * static_cast<uint32_t>(zp_a);
  if (conv_order == 2) return launch<kBf16>(p, true, tile, slices, kslice, loader, stream);
  if (conv_order < 0 || conv_order > 2) return static_cast<int>(cudaErrorInvalidValue);
  return launch<kRequant>(p, true, tile, slices, kslice, loader, stream);
}

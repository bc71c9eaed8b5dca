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
// Bound on an H100 at the decode shapes (M = 8): the packed weight bytes,
// a fraction of a microsecond to 4 us, so a launch's time is its dependent
// chain (load, MMAs, fold, store) and the number of blocks that share it.
// Design, from what held B6 back at M = 8 (16 blocks of 16 x 64 walking all
// of K in 64-value stages, three barriers a stage, half of each m16 MMA
// padding): the operands are swapped, out^T = W x^T on mma.sync m16n8k32,
// so the unpacked weight codes are the A operand (16 output columns a warp)
// and the batch rows the n8 B operand: a block's tile is 16 rows (two n8
// fragments, the second empty at M = 8, which the sweep still found
// faster than 8-row tiles at every decode shape) by 64 columns.  The packed codes are unpacked in registers, straight into the
// A fragments, in B7's k order; a four-stage cp.async ring of 256 k values
// (a whole 128-byte line of each packed row; K = 768 is in flight at once)
// with one barrier a stage; the group scales and the epilogue's vectors are
// loaded while the ring fills (a group ahead of each fold; for a K split,
// all of them into slice 0's shared memory, so that no global load follows
// the cluster's barrier); the u8 tile leaves through shared memory in
// 16-byte row runs.  Where the tiles are fewer than the SMs, K is split over up to 8
// blocks of a thread block cluster, each slice a whole number of groups or
// a whole fraction of one: every slice keeps its s32 per-group partials in
// its shared memory, and slice 0 adds a group's partials over the slices in
// s32 (exact in any order) through distributed shared memory and runs the
// f32 fold alone, in group order; no f32 value is summed across slices, so
// the codes are the same at every split.  ops/w4.plan_w4a8_v2 chooses the
// tile and the slices; the launcher runs that plan or refuses it.  A group
// is a multiple of 32 values (the MMA's k), K a multiple of the group.
//
// w4a8_v1_gemm (B7; replaces ::_w4a8_kernel, launched by _w4a8_pallas_impl)
// and w4_gemm (B5; replaces ::_w4_kernel, launched by _w4_pallas_impl)
// share one tensor-core main loop, the template's two instances.  Both
// factor the group scale out of the dot product:
//
//   B7: I_g = sum_{k in g} (x[m, k] - 128) * code     exact s32, int8 MMAs
//       acc = I_0 * s_0;  acc = acc + I_g * s_g       (B6's fold, any M)
//       out = floor(clip(acc * mult[n] + zpb_eff[n], 0, 255) + rb)     u8
//   B5: P_g = sum_{k in g} x[m, k] * code             bf16 MMAs, f32 sums
//       acc = P_0 * s_0;  acc = acc + P_g * s_g;  out = acc + bias[n]  f32
//
// B7 is B6's arithmetic on every shape: equal bit for bit to
// ops/w4.w4a8_v2_plain (generalised to any M and a short last group), and
// within B7's contract (at most 1 code off on at most 0.2%) of the f32
// function w4a8_v1_plain, which the CPU path runs.  B5 splits each f32 x
// inside the kernel into three bf16 pieces, hi + mid + lo == x exactly (the
// top 16 bits of x, then of each remainder; ops/w4.split_bf16x3 is the plain
// twin), and a 4-bit code is exact in bf16, so the three MMAs per k-step (lo,
// then mid, then hi, into one f32 accumulator per group) form every product
// exactly; only the f32 sums round.  Held to 2e-5 of the largest |output|
// of w4_gemm_plain.
// Bound on an H100 at the prefill / forward shapes (M = 512): B7 sits at the
// crossover of its bytes and its int8 operations at 1,979 TOP/s (N = 768:
// the bytes; wider N: the operations); B5 is bound by its three bf16 passes
// at 989 TFLOP/s.
// Design: mma.sync (s8 m16n8k32 for B7, bf16 m16n8k16 for B5) on a 64 x 64
// output tile per block of four warps (B7: 2 x 2 warps of 32 x 32; B5: 4 x 1
// warps of 16 x 64, so that no two warps split the same x), K through a
// cp.async ring in dynamic shared memory (B7: four stages of 128 k values;
// B5: three of 64; 61,440 bytes, three blocks an SM), one barrier a stage.
// The packed stage is unpacked in registers, straight into the B fragments
// (an OR, a SUB and an XOR a word for s8; a 0x4300 | nibble bias and one
// bf16x2 FMA for bf16), in a k order that lets each thread read one packed
// word and one 8- or 16-byte x run per row.  Each group's scales and the
// epilogue's vectors are loaded a group ahead, off the critical path; B7's
// u8 tile leaves through shared memory in 16-byte row runs.  A 64 x 64 tile
// gives 96 blocks at N = 768 and M = 512.  B5 splits K over its groups
// where a grid has fewer tiles than SMs (wq, wk, wv, proj and down at M =
// 512): up to 8 slices of a tile run as one thread block cluster, and slice
// 0 adds the others' partials, read from their shared memory, in slice
// order (deterministic, no atomics, no second launch).  B7 never splits:
// its exact fold runs over the groups in order.  Groups: a chunk of 32 k
// values that a group boundary splits (a group not a multiple of 32 and
// smaller than K) runs once per group it touches, with the B lanes of the
// other groups zeroed, so every partial stays exact; group 128 and 256
// never take that path, and a whole stage then runs branch-free.  Any M, N
// and even K: K % 32 != 0 or an unaligned base takes an element loader
// instead of 16-byte cp.async.  Not wgmma: a B7 path on m64n64k32 wgmma
// (A from registers, the codes unpacked once a stage into the no-swizzle
// core-matrix layout) was exact but slower, because the per-stage unpack
// and its barrier sit on the critical path and ptxas then retires every
// wgmma before the loop's back-edge; overlapping them needs producer and
// consumer warps, which is later work (PERF.md).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

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

// four packed bytes (eight k values) -> two words of s8 codes in k order:
// (nibble | 0x80) - 8 borrows nothing from the next byte, and ^ 0x80 then
// leaves nibble - 8
__device__ __forceinline__ void unpack_s8(uint32_t v, uint32_t& lo_word, uint32_t& hi_word) {
  const uint32_t h = (((v >> 4) & 0x0F0F0F0Fu) | 0x80808080u) - 0x08080808u;   // even k
  const uint32_t l = ((v & 0x0F0F0F0Fu) | 0x80808080u) - 0x08080808u;          // odd k
  lo_word = __byte_perm(h, l, 0x5140) ^ 0x80808080u;
  hi_word = __byte_perm(h, l, 0x7362) ^ 0x80808080u;
}

// ---------------------------------------------------------------------------
// B6
// ---------------------------------------------------------------------------

namespace v2 {

constexpr int BM = 16;               // block tile: batch rows, two n8 fragments (out^T = W x^T)
constexpr int MI = BM / 8;
constexpr int BN = 64;               // block tile: output columns (four warps of 16)
constexpr int BK = 256;              // k values per ring stage (a 128-byte packed row run)
constexpr int STAGES = 4;            // ring stages
constexpr int NT = 128;
constexpr int LDX = BK + 32;         // x row: a quarter-warp's 8-byte reads on distinct banks
constexpr int LDP = BK / 2 + 16;     // packed row: an odd multiple of 16 bytes
constexpr int MAX_SLICES = 8;        // a portable cluster

struct Ring {
  uint8_t x[STAGES][BM][LDX];
  uint8_t p[STAGES][BN][LDP];
};

struct Params {
  const uint8_t* x;                  // u8 [M, K]
  const uint8_t* pk;                 // [N, K/2]
  const float* sct;                  // scales_t [G, N]
  const float* mult;                 // [N]
  const float* zpb;                  // zpb_eff [N]
  uint8_t* out;                      // u8 [M, N]
  int M, N, K, group, G;
  int kslice;                        // K values of each slice (blockIdx.z)
  int part_groups;                   // groups one slice touches (its partials)
  float rb;
};

// Dynamic shared memory: the ring and, for a K split, the tile's columns'
// f32 mult, zpb_eff and every group's scale ([2 + G][BN], which slice 0
// folds and requantizes with after the cluster's barrier) and each slice's
// s32 partials.
constexpr int RING_BYTES = static_cast<int>(sizeof(Ring));
int smem_bytes(int slices, int G, int part_groups) {
  return RING_BYTES + (slices > 1 ? (2 + G) * BN * 4 + part_groups * BM * BN * 4 : 0);
}

// Stage `s` <- x rows m0.., packed rows n0.., k values [k0, k0 + BK), zero
// past `kend` (the slice's end: the next slice's values are never summed
// here) and past M and N.  K % 32 == 0 and 16-byte aligned bases, so every
// 16-byte chunk is wholly inside or outside.
__device__ __forceinline__ void load_stage(Ring& sm, int s, const Params& p, int m0, int n0,
                                           int k0, int kend, int tid) {
  constexpr int XC = BK / 16;                          // chunks per x row
#pragma unroll
  for (int i = 0; i < (BM * XC + NT - 1) / NT; ++i) {
    const int c = tid + i * NT;
    if (c < BM * XC) {
      const int r = c / XC;
      const int col = (c % XC) * 16;
      const bool ok = m0 + r < p.M && k0 + col < kend;
      const uint8_t* src = ok ? p.x + static_cast<size_t>(m0 + r) * p.K + k0 + col : p.x;
      cp_async16(&sm.x[s][r][col], src, ok ? 16 : 0);
    }
  }
  constexpr int PC = BK / 32;                          // chunks per packed row
#pragma unroll
  for (int i = 0; i < BN * PC / NT; ++i) {
    const int c = tid + i * NT;
    const int r = c / PC;
    const int col = (c % PC) * 16;
    const bool ok = n0 + r < p.N && k0 + 2 * col < kend;
    const uint8_t* src = ok ? p.pk + static_cast<size_t>(n0 + r) * (p.K / 2) + k0 / 2 + col : p.pk;
    cp_async16(&sm.p[s][r][col], src, ok ? 16 : 0);
  }
}

// group gi's scales of this thread's two columns n and n + 8 (0 past N and
// past the last group), loaded a group ahead of the fold that reads them
__device__ __forceinline__ void group_scales(float (&sc)[2], const Params& p, int n, int gi) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
    sc[h] = n + 8 * h < p.N && gi < p.G ? p.sct[static_cast<size_t>(gi) * p.N + n + 8 * h] : 0.0f;
}

// Accumulator element j of m-fragment mi: column (n) wn + g + 8 * (j / 2),
// row (m) mi * 8 + 2t + j % 2.
__device__ __forceinline__ void fold(const int32_t (&ints)[MI][4], float (&accf)[MI][4],
                                     const float (&sc)[2], bool first) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float term = __fmul_rn(__int2float_rn(ints[mi][j]), sc[j >> 1]);
      accf[mi][j] = first ? term : __fadd_rn(accf[mi][j], term);
    }
}

__global__ void __launch_bounds__(NT) w4a8_v2_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  Ring& sm = *reinterpret_cast<Ring*>(smem);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wn = (tid >> 5) * 16;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int slices = gridDim.z;
  const int kbeg = blockIdx.z * p.kslice;
  const int kend = kbeg + p.kslice;

  int32_t acc[MI][4];
  float accf[MI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[mi][j] = 0;
      accf[mi][j] = 0.0f;
    }
  const int nk = (p.kslice + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(sm, s, p, m0, n0, kbeg + s * BK, kend, tid);
    cp_async_commit();
  }
  const int cn = wn + g;             // this thread's columns: cn and cn + 8 of the tile
  // The epilogue's vectors and the group scales, loaded while the ring
  // fills: in registers, the next group's a group ahead of its fold, or,
  // for a K split, slice 0's copy of all of them in shared memory, read
  // after the cluster's barrier.
  float ev[2][2], sc[2];
  float* vec = reinterpret_cast<float*>(smem + RING_BYTES);   // [2 + G][BN]
  if (slices == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + cn + 8 * h;
      ev[0][h] = n < p.N ? p.mult[n] : 0.0f;
      ev[1][h] = n < p.N ? p.zpb[n] : 0.0f;
    }
    group_scales(sc, p, n0 + cn, 0);
  } else if (blockIdx.z == 0) {
    for (int i = tid; i < (2 + p.G) * BN; i += NT) {
      const int row = i / BN;
      const int n = n0 + i % BN;
      const float* src =
          row == 0 ? p.mult : row == 1 ? p.zpb : p.sct + static_cast<size_t>(row - 2) * p.N;
      vec[i] = n < p.N ? src[n] : 0.0f;
    }
  }

  // a K split keeps each group's exact partial (slice-local index l)
  int32_t* part = reinterpret_cast<int32_t*>(vec + (2 + p.G) * BN);
  int gi = kbeg / p.group;           // the group being summed
  int l = 0;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    // stage kt has landed for every thread, and every thread is done with
    // stage kt - 1, whose slot the prefetch below overwrites
    __syncthreads();
    const int pf = kt + STAGES - 1;
    if (pf < nk) load_stage(sm, pf % STAGES, p, m0, n0, kbeg + pf * BK, kend, tid);
    cp_async_commit();

    const int s = kt % STAGES;
    const int k0 = kbeg + kt * BK;
#pragma unroll
    for (int c = 0; c < BK / 32; ++c) {
      const int kk = k0 + c * 32;
      if (kk >= kend) break;
      // A: the weight codes of columns nt and nt + 8, k 8t..8t+7 of the
      // chunk, unpacked in registers (B7's k order, the MMA's slots 4t..
      // 4t+3 and 16+4t.. carry k 8t..8t+3 and 8t+4..8t+7)
      uint32_t a[4];
      unpack_s8(*reinterpret_cast<const uint32_t*>(&sm.p[s][wn + g][c * 16 + 4 * t]), a[0],
                     a[2]);
      unpack_s8(*reinterpret_cast<const uint32_t*>(&sm.p[s][wn + g + 8][c * 16 + 4 * t]),
                     a[1], a[3]);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        // B: batch row mi * 8 + g at the same k, recentred (x ^ 0x80 = x - 128)
        const uint2 xv = *reinterpret_cast<const uint2*>(&sm.x[s][mi * 8 + g][c * 32 + 8 * t]);
        const uint32_t b[2] = {xv.x ^ 0x80808080u, xv.y ^ 0x80808080u};
        mma_s8(acc[mi], a, b);
      }
      if ((kk + 32) % p.group == 0 || kk + 32 == kend) {
        if (slices == 1) {
          // the group ends here: its exact partial into the f32 sum
          fold(acc, accf, sc, gi == 0);
          ++gi;
          group_scales(sc, p, n0 + cn, gi);
        } else {
          // a K split: slice 0 adds the partials of a group over the slices
#pragma unroll
          for (int i = 0; i < MI * 4; ++i) part[(l * MI * 4 + i) * NT + tid] = acc[i / 4][i % 4];
          ++l;
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[mi][j] = 0;
      }
    }
  }
  cp_async_wait<0>();

  if (slices > 1) {
    // Slice 0 reads every slice's partials through distributed shared
    // memory: a group's partials add in s32 (exact in any order), and the
    // f32 fold then runs over the groups in order in slice 0 alone, so no
    // f32 value is ever summed across slices.
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (cluster.block_rank() == 0) {
      for (int g2 = 0; g2 < p.G; ++g2) {
        int32_t ints[MI][4] = {};
        const int r0 = g2 * p.group / p.kslice;
        const int r1 = ((g2 + 1) * p.group - 1) / p.kslice;
        for (int r = r0; r <= r1; ++r) {
          const int32_t* other = cluster.map_shared_rank(part, r);
          const int lr = g2 - r * p.kslice / p.group;
#pragma unroll
          for (int i = 0; i < MI * 4; ++i) ints[i / 4][i % 4] += other[(lr * MI * 4 + i) * NT + tid];
        }
        const float* s2 = vec + (2 + g2) * BN + cn;
        const float pair[2] = {s2[0], s2[8]};
        fold(ints, accf, pair, g2 == 0);
      }
    }
    // the other slices' shared memory stays readable until slice 0 is done
    cluster.sync();
    if (cluster.block_rank() != 0) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ev[0][h] = vec[cn + 8 * h];
      ev[1][h] = vec[BN + cn + 8 * h];
    }
  }

  // the u8 tile [BM][BN] through shared memory (the ring is free now), then
  // out in 16-byte row runs
  constexpr int LDO = BN + 16;
  __syncthreads();
  uint8_t* tile = smem;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      tile[(mi * 8 + 2 * t + (j & 1)) * LDO + cn + 8 * (j >> 1)] =
          clip_floor(__fadd_rn(__fmul_rn(accf[mi][j], ev[0][j >> 1]), ev[1][j >> 1]), p.rb);
  __syncthreads();
  const bool vec16 = p.N % 16 == 0 && reinterpret_cast<uintptr_t>(p.out) % 16 == 0;
  for (int i = tid; i < BM * BN / 16; i += NT) {
    const int r = i / (BN / 16);
    const int c = i % (BN / 16) * 16;
    const int m = m0 + r;
    if (m >= p.M || n0 + c >= p.N) continue;
    const size_t o = static_cast<size_t>(m) * p.N + n0 + c;
    if (vec16) {
      *reinterpret_cast<uint4*>(p.out + o) = *reinterpret_cast<const uint4*>(&tile[r * LDO + c]);
    } else {
      for (int j = 0; j < 16 && n0 + c + j < p.N; ++j) p.out[o + j] = tile[r * LDO + c + j];
    }
  }
}

// The plan (ops/w4.plan_w4a8_v2) is checked, never adjusted: a plan this
// file cannot run is refused with cudaErrorInvalidValue.
int launch(Params p, int slices, int kslice, cudaStream_t stream) {
  if (p.M <= 0 || p.N <= 0 || p.K <= 0 || p.group <= 0 || p.group % 32 || p.K % p.group ||
      reinterpret_cast<uintptr_t>(p.x) % 16 || reinterpret_cast<uintptr_t>(p.pk) % 16 ||
      slices < 1 || slices > MAX_SLICES || kslice <= 0 || kslice % 32 ||
      static_cast<long long>(kslice) * slices != p.K ||
      (p.group % kslice != 0 && kslice % p.group != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  p.G = p.K / p.group;
  p.kslice = kslice;
  p.part_groups = kslice > p.group ? kslice / p.group : 1;
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, slices);
  const int bytes = smem_bytes(slices, p.G, p.part_groups);
  if (grid.y > 65535 || bytes > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr =
      cudaFuncSetAttribute(w4a8_v2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (slices == 1) {
    w4a8_v2_kernel<<<grid, NT, bytes, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = slices;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, w4a8_v2_kernel, p);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace v2

// ---------------------------------------------------------------------------
// B5 and B7: one tensor-core main loop
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BM = 64;               // block tile rows
constexpr int BN = 64;               // block tile columns
constexpr int NT = 128;              // four warps
constexpr int KC = 32;               // k values per chunk: one s8 k-step, two bf16 k-steps

// A kernel's warps over the 64 x 64 output tile and its cp.async ring of x
// and packed-weight stages.  B7: warps of 32 x 32, four stages of 128 k
// values.  B5: four warps of 16 x 64 (along M, so that no two warps split
// the same x), three stages of 64.  A row of x is padded so that a warp's
// 8-byte (u8) or 16-byte (f32) fragment reads hit distinct banks; a packed
// row to an odd multiple of 16 bytes, so that its 4-byte reads do.
template <bool kW4A8>
struct Ring {
  using X = typename std::conditional<kW4A8, uint8_t, float>::type;
  static constexpr int WM = kW4A8 ? 2 : 4;           // warps along M
  static constexpr int WN = 4 / WM;                  // warps along N
  static constexpr int MI = BM / (16 * WM);          // m16 fragments per warp
  static constexpr int NI = BN / (8 * WN);           // n8 fragments per warp
  static constexpr int BK = kW4A8 ? 128 : 64;
  static constexpr int STAGES = kW4A8 ? 4 : 3;
  static constexpr int LDX = kW4A8 ? BK + 32 : BK + 4;
  static constexpr int LDP = BK / 2 % 32 == 16 ? BK / 2 : BK / 2 + 16;
  X x[STAGES][BM][LDX];
  uint8_t p[STAGES][BN][LDP];
};

struct Params {
  const void* x;                     // u8 (B7) or f32 (B5) [M, K]
  const uint8_t* pk;                 // [N, K/2]
  const float* scales;               // B7: scales_t [G, N]; B5: scales [N, G]
  const float* vec;                  // B7: mult [N]; B5: bias [N]
  const float* zpb;                  // B7: zpb_eff [N]; B5: unused
  void* out;                         // u8 (B7) or f32 (B5) [M, N]
  int M, N, K, g, G;                 // g: the effective group, min(group, K)
  int gps;                           // groups per K slice (blockIdx.z); G unsplit
  float rb;
};

// Stage `s` <- x rows m0.., packed rows n0.., k values k0.. .  kVec: K % 32
// == 0 and 16-byte aligned bases, so every 16-byte chunk is wholly inside or
// outside the matrix and cp.async zero-fills the outside (the main loop
// never reads past K).  Otherwise a plain element loader fills x past K with
// the value whose product is 0 (u8 128, f32 0) and packed bytes with 0x88
// (two zero codes).
template <bool kW4A8, bool kVec>
__device__ __forceinline__ void load_stage(Ring<kW4A8>& sm, int s, const Params& p, int m0,
                                           int n0, int k0, int tid) {
  using R = Ring<kW4A8>;
  using X = typename R::X;
  const X* x = static_cast<const X*>(p.x);
  if (kVec) {
    constexpr int XV = 16 / static_cast<int>(sizeof(X));   // x values per chunk
    constexpr int XC = R::BK / XV;                         // chunks per x row
#pragma unroll
    for (int i = 0; i < BM * XC / NT; ++i) {
      const int c = tid + i * NT;
      const int r = c / XC;
      const int col = (c % XC) * XV;
      const bool ok = m0 + r < p.M && k0 + col < p.K;
      const X* src = ok ? x + static_cast<size_t>(m0 + r) * p.K + k0 + col : x;
      cp_async16(&sm.x[s][r][col], src, ok ? 16 : 0);
    }
    constexpr int PC = R::BK / 32;                         // chunks per packed row
    for (int c = tid; c < BN * PC; c += NT) {
      const int r = c / PC;
      const int col = (c % PC) * 16;
      const bool ok = n0 + r < p.N && k0 + 2 * col < p.K;
      const uint8_t* src =
          ok ? p.pk + static_cast<size_t>(n0 + r) * (p.K / 2) + k0 / 2 + col : p.pk;
      cp_async16(&sm.p[s][r][col], src, ok ? 16 : 0);
    }
  } else {
    const X pad = kW4A8 ? X(128) : X(0);
    for (int i = tid; i < BM * R::BK; i += NT) {
      const int m = m0 + i / R::BK;
      const int k = k0 + i % R::BK;
      sm.x[s][i / R::BK][i % R::BK] =
          m < p.M && k < p.K ? x[static_cast<size_t>(m) * p.K + k] : pad;
    }
    for (int i = tid; i < BN * R::BK / 2; i += NT) {
      const int n = n0 + i / (R::BK / 2);
      const int k = k0 + 2 * (i % (R::BK / 2));
      sm.p[s][i / (R::BK / 2)][i % (R::BK / 2)] =
          n < p.N && k < p.K ? p.pk[static_cast<size_t>(n) * (p.K / 2) + k / 2] : uint8_t(0x88);
    }
  }
}

// The k order inside a 32-value chunk.  Thread t (lane % 4) reads one
// packed word, bytes 4t..4t+3 of the chunk's 16, i.e. k values 8t..8t+7, and
// feeds them to the MMA in the B-fragment slots the hardware gives it; its
// A fragment takes x at the same k values.  The MMA sums over k, so the
// permutation changes nothing: the integer sums are exact and the bf16
// products are exact.
//   s8 m16n8k32: b0 = k 8t..8t+3, b1 = k 8t+4..8t+7; A row r: one 8-byte
//     read at x[r][8t], its words in a0/a2 (rows g) and a1/a3 (rows g + 8).
//   bf16 m16n8k16, k-step s of the chunk: b0 = k 8t+4s, +1, b1 = k 8t+4s+2,
//     +3; A row r: one 16-byte read at x[r][8t + 4s].

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x0, x1 -> bf16x2 words hi, mid, lo with hi + mid + lo == x exactly: each
// piece is the top 16 bits of what is left (a truncating split: no
// conversion instructions, and the two subtractions are exact).  The plain
// twin is ops/w4.split_bf16x3.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const uint32_t h0 = __float_as_uint(x0) & 0xFFFF0000u;
  const uint32_t h1 = __float_as_uint(x1) & 0xFFFF0000u;
  const float r0 = __fsub_rn(x0, __uint_as_float(h0));
  const float r1 = __fsub_rn(x1, __uint_as_float(h1));
  const uint32_t m0 = __float_as_uint(r0) & 0xFFFF0000u;
  const uint32_t m1 = __float_as_uint(r1) & 0xFFFF0000u;
  const float l0 = __fsub_rn(r0, __uint_as_float(m0));
  const float l1 = __fsub_rn(r1, __uint_as_float(m1));
  hi = __byte_perm(h0, h1, 0x7632);
  mid = __byte_perm(m0, m1, 0x7632);
  lo = __byte_perm(__float_as_uint(l0), __float_as_uint(l1), 0x7632);
}

// four packed bytes (eight k values) -> four bf16x2 words of codes in k
// order: bf16(128 + nibble) is 0x4300 | nibble, and 1 * it - 136 is the code
// nibble - 8, exactly
__device__ __forceinline__ void unpack_bf16(uint32_t v, uint32_t (&w)[4]) {
  const uint32_t h = (v >> 4) & 0x0F0F0F0Fu;    // even k
  const uint32_t l = v & 0x0F0F0F0Fu;           // odd k
  const uint32_t p01 = __byte_perm(h, l, 0x5140);
  const uint32_t p23 = __byte_perm(h, l, 0x7362);
  const uint32_t biased[4] = {__byte_perm(p01, 0x43434343u, 0x4140),
                              __byte_perm(p01, 0x43434343u, 0x4342),
                              __byte_perm(p23, 0x43434343u, 0x4140),
                              __byte_perm(p23, 0x43434343u, 0x4342)};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
        : "=r"(w[i]) : "r"(biased[i]), "r"(0x3F803F80u), "r"(0xC308C308u));
}

// the lanes (kLanes = 4: bytes of an s8 word; 2: halves of a bf16x2 word)
// of a B register, holding k, k + 1, ..., whose chunk-local k lies in
// [lo, hi)
template <int kLanes>
__device__ __forceinline__ uint32_t lane_mask(int k, int lo, int hi) {
  uint32_t m = 0;
#pragma unroll
  for (int j = 0; j < kLanes; ++j)
    if (k + j >= lo && k + j < hi) m |= (kLanes == 4 ? 0xFFu : 0xFFFFu) << (j * 32 / kLanes);
  return m;
}

// One chunk's MMAs for this warp.  `xw`/`pw` point at the warp's first A row
// and first B column at the chunk's start, offset for lane (g, t).  kMasked:
// only the k in [lo, hi) of the chunk count (a group boundary inside it); the
// B lanes outside are zeroed, so each group's partial stays exact.
template <bool kMasked, int MI, int NI>
__device__ __forceinline__ void chunk(int32_t (&acc)[MI][NI][4], const uint8_t* xw,
                                      const uint8_t* pw, int t, int lo, int hi) {
  using R = Ring<true>;
  uint32_t af[MI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const uint2 r0 = *reinterpret_cast<const uint2*>(xw + mi * 16 * R::LDX);
    const uint2 r8 = *reinterpret_cast<const uint2*>(xw + (mi * 16 + 8) * R::LDX);
    // XOR 0x80 maps each u8 byte to the s8 value x - 128
    af[mi][0] = r0.x ^ 0x80808080u;
    af[mi][1] = r8.x ^ 0x80808080u;
    af[mi][2] = r0.y ^ 0x80808080u;
    af[mi][3] = r8.y ^ 0x80808080u;
  }
  const uint32_t mk0 = kMasked ? lane_mask<4>(8 * t, lo, hi) : ~0u;
  const uint32_t mk1 = kMasked ? lane_mask<4>(8 * t + 4, lo, hi) : ~0u;
  uint32_t bf[NI][2];
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    unpack_s8(*reinterpret_cast<const uint32_t*>(pw + ni * 8 * R::LDP), bf[ni][0],
              bf[ni][1]);
    bf[ni][0] &= mk0;
    bf[ni][1] &= mk1;
  }
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
}

template <bool kMasked, int MI, int NI>
__device__ __forceinline__ void chunk(float (&acc)[MI][NI][4], const float* xw,
                                      const uint8_t* pw, int t, int lo, int hi) {
  using R = Ring<false>;
  uint32_t codes[NI][4];
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
    unpack_bf16(*reinterpret_cast<const uint32_t*>(pw + ni * 8 * R::LDP), codes[ni]);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    uint32_t ah[MI][4], am[MI][4], al[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const float4 u = *reinterpret_cast<const float4*>(xw + mi * 16 * R::LDX + 4 * s);
      const float4 v = *reinterpret_cast<const float4*>(xw + (mi * 16 + 8) * R::LDX + 4 * s);
      split3(u.x, u.y, ah[mi][0], am[mi][0], al[mi][0]);
      split3(v.x, v.y, ah[mi][1], am[mi][1], al[mi][1]);
      split3(u.z, u.w, ah[mi][2], am[mi][2], al[mi][2]);
      split3(v.z, v.w, ah[mi][3], am[mi][3], al[mi][3]);
    }
    const uint32_t mk0 = kMasked ? lane_mask<2>(8 * t + 4 * s, lo, hi) : ~0u;
    const uint32_t mk1 = kMasked ? lane_mask<2>(8 * t + 4 * s + 2, lo, hi) : ~0u;
    uint32_t b[NI][2];
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      b[ni][0] = codes[ni][2 * s] & mk0;
      b[ni][1] = codes[ni][2 * s + 1] & mk1;
    }
    // lo, then mid, then hi into each accumulator; the eight accumulators
    // interleave so that back-to-back MMAs are independent
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) mma_bf16(acc[mi][ni], al[mi], b[ni][0], b[ni][1]);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) mma_bf16(acc[mi][ni], am[mi], b[ni][0], b[ni][1]);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) mma_bf16(acc[mi][ni], ah[mi], b[ni][0], b[ni][1]);
  }
}

__device__ __forceinline__ float as_f32(int32_t v) { return __int2float_rn(v); }
__device__ __forceinline__ float as_f32(float v) { return v; }

// Accumulator element j of fragment (mi, ni): row g + 8 * (j / 2) of the
// m16 tile, column nw + ni * 8 + 2t + j % 2.  A thread's per-column values
// are v[ni][j % 2].

// group gi's scales of this thread's columns (0 past N and past the last
// group), loaded a group ahead of the fold that reads them
template <bool kW4A8, int NI>
__device__ __forceinline__ void group_scales(float (&sc)[NI][2], const Params& p, int nw, int t,
                                             int gi) {
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int jn = 0; jn < 2; ++jn) {
      const int n = nw + ni * 8 + 2 * t + jn;
      sc[ni][jn] = n >= p.N || gi >= p.G ? 0.0f
                   : kW4A8               ? p.scales[static_cast<size_t>(gi) * p.N + n]
                                         : p.scales[static_cast<size_t>(n) * p.G + gi];
    }
}

// a group's partial into the f32 sum (acc = P_0 * s_0, then acc + P_g *
// s_g), and the partial cleared
template <typename Acc, int MI, int NI>
__device__ __forceinline__ void fold(Acc (&acc)[MI][NI][4], float (&accf)[MI][NI][4],
                                     const float (&sc)[NI][2], bool first) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float term = __fmul_rn(as_f32(acc[mi][ni][j]), sc[ni][j & 1]);
        accf[mi][ni][j] = first ? term : __fadd_rn(accf[mi][ni][j], term);
        acc[mi][ni][j] = Acc(0);
      }
}

template <bool kW4A8, bool kVec>
__global__ void __launch_bounds__(NT, 3) w4_tc_kernel(Params p) {
  using R = Ring<kW4A8>;
  using Acc = typename std::conditional<kW4A8, int32_t, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  R& sm = *reinterpret_cast<R*>(smem);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  constexpr int MI = R::MI, NI = R::NI;
  const int wm = warp / R::WN * (BM / R::WM);
  const int wn = warp % R::WN * (BN / R::WN);
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  Acc acc[MI][NI][4];
  float accf[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[mi][ni][j] = Acc(0);
        accf[mi][ni][j] = 0.0f;
      }

  // the epilogue's vectors (B7: mult, zpb_eff; B5: bias) and the first
  // group's scales, loaded while the ring fills
  float ev[2][NI][2];
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int jn = 0; jn < 2; ++jn) {
      const int n = n0 + wn + ni * 8 + 2 * t + jn;
      ev[0][ni][jn] = n < p.N ? p.vec[n] : 0.0f;
      ev[1][ni][jn] = kW4A8 && n < p.N ? p.zpb[n] : 0.0f;
    }
  // this block's K slice: groups gi0 .. gi0 + gps - 1
  const int gi0 = blockIdx.z * p.gps;
  const int kbeg = gi0 * p.g;
  const int kend = p.K - kbeg > p.gps * p.g ? kbeg + p.gps * p.g : p.K;
  float sc[NI][2];
  group_scales<kW4A8>(sc, p, n0 + wn, t, gi0);

  const int nk = (kend - kbeg + R::BK - 1) / R::BK;
#pragma unroll
  for (int s = 0; s < R::STAGES - 1; ++s) {
    if (s < nk) load_stage<kW4A8, kVec>(sm, s, p, m0, n0, kbeg + s * R::BK, tid);
    if (kVec) cp_async_commit();
  }

  // every group boundary on a stage boundary: whole stages run unmasked
  // and straight-line, the fold after them
  const bool aligned = kVec && (p.g % R::BK == 0 || p.g >= p.K);
  int gi = gi0;                      // the group being summed
  int gend = p.K - kbeg > p.g ? kbeg + p.g : p.K;   // where it ends
  auto end_group = [&]() {
    fold(acc, accf, sc, gi == gi0);
    ++gi;
    group_scales<kW4A8>(sc, p, n0 + wn, t, gi);
    gend = p.K - gend > p.g ? gend + p.g : p.K;
  };
  for (int kt = 0; kt < nk; ++kt) {
    if (kVec) cp_async_wait<R::STAGES - 2>();
    // stage kt has landed for every thread, and every thread is done with
    // stage kt - 1, whose slot the prefetch below overwrites
    __syncthreads();
    const int pf = kt + R::STAGES - 1;
    if (pf < nk)
      load_stage<kW4A8, kVec>(sm, pf % R::STAGES, p, m0, n0, kbeg + pf * R::BK, tid);
    if (kVec) cp_async_commit();

    const int s = kt % R::STAGES;
    const int k0 = kbeg + kt * R::BK;
    const auto* xs = &sm.x[s][wm + g][8 * t];
    const uint8_t* ps = &sm.p[s][wn + g][4 * t];
    if (aligned && k0 + R::BK <= kend) {
#pragma unroll
      for (int c = 0; c < R::BK / KC; ++c)
        chunk<false>(acc, xs + c * KC, ps + c * KC / 2, t, 0, KC);
      if (k0 + R::BK == gend) end_group();
      continue;
    }
    for (int c = 0; c < R::BK / KC; ++c) {
      const int kk = k0 + c * KC;
      if (kk >= kend) break;
      const int cend = min(kk + KC, kend);
      // the chunk's segments, one per group it touches
      int c0 = kk;
      do {
        const int seg = min(gend, cend);
        if (c0 == kk && seg == cend) {
          chunk<false>(acc, xs + c * KC, ps + c * KC / 2, t, 0, KC);
        } else {
          chunk<true>(acc, xs + c * KC, ps + c * KC / 2, t, c0 - kk, seg - kk);
        }
        if (seg == gend) end_group();
        c0 = seg;
      } while (c0 < cend);
    }
  }

  if constexpr (!kW4A8) {
    if (gridDim.z > 1) {
      // B5 split over K: the slices of a tile are one thread block cluster;
      // each leaves its partial in its own shared memory (the ring is free
      // now), and slice 0 adds the others to its own in slice order, so the
      // sum does not depend on which slice finished first
      namespace cg = cooperative_groups;
      cg::cluster_group cluster = cg::this_cluster();
      cp_async_wait<0>();
      __syncthreads();
      float* part = reinterpret_cast<float*>(smem);
#pragma unroll
      for (int i = 0; i < MI * NI * 4; ++i)
        part[i * NT + tid] = accf[i / (NI * 4)][i / 4 % NI][i % 4];
      cluster.sync();
      if (cluster.block_rank() == 0) {
        for (unsigned r = 1; r < gridDim.z; ++r) {
          const float* other = cluster.map_shared_rank(part, r);
#pragma unroll
          for (int i = 0; i < MI * NI * 4; ++i) {
            float& a = accf[i / (NI * 4)][i / 4 % NI][i % 4];
            a = __fadd_rn(a, other[i * NT + tid]);
          }
        }
      }
      // the other slices' shared memory stays readable until slice 0 is done
      cluster.sync();
      if (cluster.block_rank() != 0) return;
    }
  }

  if constexpr (kW4A8) {
    // the u8 tile through shared memory (the ring is free now), then out in
    // 16-byte row runs
    constexpr int LDO = BN + 16;       // a warp's 2-byte writes hit distinct banks
    cp_async_wait<0>();
    __syncthreads();
    uint8_t* tile = smem;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int jm = 0; jm < 2; ++jm) {
          uint32_t q[2];
#pragma unroll
          for (int jn = 0; jn < 2; ++jn)
            q[jn] = clip_floor(__fadd_rn(__fmul_rn(accf[mi][ni][2 * jm + jn], ev[0][ni][jn]),
                                         ev[1][ni][jn]), p.rb);
          const int r = wm + mi * 16 + g + 8 * jm;
          *reinterpret_cast<uint16_t*>(&tile[r * LDO + wn + ni * 8 + 2 * t]) =
              static_cast<uint16_t>(q[0] | q[1] << 8);
        }
    __syncthreads();
    auto* out = static_cast<uint8_t*>(p.out);
    const bool vec16 = p.N % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
    for (int i = tid; i < BM * BN / 16; i += NT) {
      const int r = i / (BN / 16);
      const int c = i % (BN / 16) * 16;
      const int m = m0 + r;
      if (m >= p.M) continue;
      const size_t o = static_cast<size_t>(m) * p.N + n0 + c;
      if (vec16 && n0 + c + 16 <= p.N) {
        *reinterpret_cast<uint4*>(out + o) =
            *reinterpret_cast<const uint4*>(&tile[r * LDO + c]);
      } else {
        for (int j = 0; j < 16 && n0 + c + j < p.N; ++j) out[o + j] = tile[r * LDO + c + j];
      }
    }
  } else {
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int n = n0 + wn + ni * 8 + 2 * t;
      if (n >= p.N) continue;
      const bool pair = n + 1 < p.N;
      const bool vec2 = pair && p.N % 2 == 0;      // an 8-byte aligned f32 pair
      auto* out = static_cast<float*>(p.out);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
        for (int jm = 0; jm < 2; ++jm) {
          const int m = m0 + wm + mi * 16 + g + 8 * jm;
          if (m >= p.M) continue;
          const size_t o = static_cast<size_t>(m) * p.N + n;
          const float v0 = __fadd_rn(accf[mi][ni][2 * jm], ev[0][ni][0]);
          const float v1 = __fadd_rn(accf[mi][ni][2 * jm + 1], ev[0][ni][1]);
          if (vec2) {
            *reinterpret_cast<float2*>(out + o) = make_float2(v0, v1);
          } else {
            out[o] = v0;
            if (pair) out[o + 1] = v1;
          }
        }
      }
    }
  }
}

// B5's K slices for a launch: a grid of fewer tiles than SMs waits on one
// block's pass over K, so its groups are cut into up to 8 slices (a
// portable cluster), as many as keep tiles x slices within two blocks an SM
// and divide the groups evenly.  B7 never splits: its exact fold runs
// over the groups in order.
int b5_splits(const Params& p, const dim3& grid, bool vec) {
  if (!vec || p.g % Ring<false>::BK != 0) return 1;
  int dev = 0, nsm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 1;
  const long long tiles = static_cast<long long>(grid.x) * grid.y;
  if (tiles >= nsm) return 1;
  for (int s = 8; s > 1; --s)
    if (p.G % s == 0 && tiles * s <= 2LL * nsm) return s;
  return 1;
}

template <bool kW4A8>
int launch(Params p, void* stream) {
  using R = Ring<kW4A8>;
  if (p.M <= 0 || p.N <= 0 || p.K <= 0 || p.K % 2 || p.g <= 0 ||
      (p.N + BN - 1) / BN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((p.M + BM - 1) / BM, (p.N + BN - 1) / BN);
  const bool vec = p.K % 32 == 0 && reinterpret_cast<uintptr_t>(p.x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(p.pk) % 16 == 0;
  auto* kernel = vec ? w4_tc_kernel<kW4A8, true> : w4_tc_kernel<kW4A8, false>;
  constexpr int bytes = static_cast<int>(sizeof(R));
  // above 48 KB a kernel opts in to dynamic shared memory (on the current
  // device, so at every launch)
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int splits = kW4A8 ? 1 : b5_splits(p, grid, vec);
  p.gps = p.G / splits;
  if (splits == 1) {
    kernel<<<grid, NT, bytes, static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  grid.z = splits;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, p);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace tc

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() (0 when the launch
// was accepted).  Pointers are device pointers; the caller (ops/w4.py) checks
// shapes, dtypes, contiguity and alignment.

// B6 runs the plan of ops/w4.plan_w4a8_v2: the K slices (one cluster) and
// the K values of each.
extern "C" int w4a8_v2_gemm(const void* x, const void* packed, const void* scales_t,
                            const void* mult, const void* zpb_eff, void* out, int M, int N,
                            int K, int group, int nearest, int slices, int kslice,
                            void* stream) {
  v2::Params p{};
  p.x = static_cast<const uint8_t*>(x);
  p.pk = static_cast<const uint8_t*>(packed);
  p.sct = static_cast<const float*>(scales_t);
  p.mult = static_cast<const float*>(mult);
  p.zpb = static_cast<const float*>(zpb_eff);
  p.out = static_cast<uint8_t*>(out);
  p.M = M;
  p.N = N;
  p.K = K;
  p.group = group;
  p.rb = nearest ? 0.5f : 0.0f;
  return v2::launch(p, slices, kslice, static_cast<cudaStream_t>(stream));
}

extern "C" int w4a8_v1_gemm(const void* x, const void* packed, const void* scales_t,
                            const void* mult, const void* zpb_eff, void* out, int M, int N,
                            int K, int g, int nearest, void* stream) {
  const int G = g > 0 ? (K + g - 1) / g : 0;
  const tc::Params p{x, static_cast<const uint8_t*>(packed), static_cast<const float*>(scales_t),
                     static_cast<const float*>(mult), static_cast<const float*>(zpb_eff), out,
                     M, N, K, g, G, G, nearest ? 0.5f : 0.0f};
  return tc::launch<true>(p, stream);
}

extern "C" int w4_gemm(const void* x, const void* packed, const void* scales, const void* bias,
                       void* out, int M, int N, int K, int g, void* stream) {
  const int G = g > 0 ? (K + g - 1) / g : 0;
  const tc::Params p{x, static_cast<const uint8_t*>(packed), static_cast<const float*>(scales),
                     static_cast<const float*>(bias), nullptr, out, M, N, K, g, G, G, 0.0f};
  return tc::launch<false>(p, stream);
}

// Cached-decode INT8 attention over the T-major flat u8 KV cache, for Hopper
// (sm_90a).
//
// q is u8 [B, mq, H*D] (one row per query position; head h at columns
// [h*D, (h+1)*D)), k and v are u8 [B, T, Hkv*D] (row t holds position t's
// head-merged codes), valid is s32 [B] (or one shared value): the first
// valid[b] cache rows are live for position 0, valid[b] + j for position j.
// Query head h reads kv head h / (H / Hkv) (grouped-query attention; the
// cache is never expanded).  For each query row the kernel computes the
// composed QuantMatmul -> QuantSoftmax(valid_len) -> QuantMatmul chain of
// ops/attention.py decode_attention_xla:
//
//   codes_s = trunc(clip(f32(sum_d (q - zp_q)(k - zp_k)) * mult_s + zp_s) [+0.5])
//   f       = (codes_s - zp_s) * s_s,  softcap * tanhf(f / softcap) if set
//   f       = -inf outside [valid + j - window, valid + j)
//   p       = exp(f - max) / f32(sum_f64 exp(f - max))   (exp in f64, rounded)
//   pz      = trunc(clip(p / s_p + zp_p) [+0.5]) - zp_p    (masked: exactly 0)
//   out     = trunc(clip(f32(sum_t pz * (v - zp_v)) * mult_o + zp_c) [+0.5])
//
// Both dot products are exact int32 sums.  The float steps are explicitly
// rounded intrinsics in the composed order (the file builds with
// --fmad=false).  The softmax denominator accumulates in double and rounds
// once, as ops/attention.softmax_last does: the correctly rounded float32
// sum, so the add order does not matter (a float32 sum in another order
// flips a probability code sitting on a truncation boundary, and a decode
// carries that code on through its KV cache).  Each exp runs in double and
// rounds once, for the same reason; only tanhf (the softcap) may differ
// from another libm by an ULP.
//
// Replaces the TPU kernels int8inferenceengine_tpu/ops/attention.py
// ::_decode_attn_kernel_flat_merged and ::_decode_attn_kernel_flat (both
// launched by _decode_attn_flat_impl; merged=True/False compute the same
// function).  Their bf16/f32 dot tricks and block-diagonal query operand work
// around the TPU's MXU and are not carried over.
//
// What bounds it on an H100: the bytes of the live cache rows (2 * live * D
// per (sequence, kv head)), a few MB per decode step, against the dependent
// chain (K phase -> softmax -> V phase) of each (sequence, kv head).
// Design: the live span of one (sequence, kv head) is split over T
// (flash decoding) across a thread block cluster of `splits` blocks (at
// most 8; ops/attention.plan_decode_attn chooses them from B, T and the row
// count, never from the live length, which is a device value).  Each block
// takes an equal share of the span, read on the device from valid; a share
// that is empty still joins every cluster barrier.  The probabilities are
// requantized codes that depend on the global max and sum, so the cross-split
// reductions stay exact: (1) each split's scores of its share, in its shared
// memory, and its local max per row; (2) the max exchanged through
// distributed shared memory (exact in any order); (3) each split's
// expf(f - max) and float64 partial sum, which every block adds in split
// order and rounds once (one f32 denominator in every block,
// deterministic); (4) each split's pz and its int32 P@V partials; (5) the
// partials added in s32 into split 0's shared memory (exact in any order),
// which requantizes the output once.  Three cluster barriers.  K and
// V rows arrive by 16-byte cp.async (4-byte where D or the row start is not
// 16-byte aligned), all of a share at once where the block's 64-row tile
// buffers hold it (one wait, as soon as the live length is read), else
// double-buffered, rows padded to an odd multiple of 16 bytes
// (conflict-free 16-byte reads); QK^T runs __dp4a on the
// raw bytes with the exact zero-point expansion
// sum (q - zq)(k - zk) = sum qk - zk sum q - zq sum k + D zq zk; P@V keeps
// pz as int32 and splits a short head's rows over thread groups.  Shared
// memory holds the scores of one share (rows * ceil(T / splits) * 4 bytes),
// not of all of T.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

namespace cg = cooperative_groups;

constexpr int BLK = 64;         // cache rows per tile
constexpr int NTHREADS = 128;
constexpr int MAX_SPLITS = 8;   // a portable cluster

struct Params {
  const uint8_t* q;
  const uint8_t* k;
  const uint8_t* v;
  const int32_t* valid;
  uint8_t* out;
  int T, H, Hkv, D, mq;
  long long q_sb, q_sj;         // q strides (elements) of the batch and position axes
  int valid_per_seq;            // 1: valid[b]; 0: valid[0] for every sequence
  int window;                   // < 0: none
  float softcap;                // 0: none
  int zp_q, zp_k, zp_p, zp_v;
  float mult_s, zp_s, s_s, s_p, zp_pf, mult_o, zp_c;
  int nearest;
  int splits;                   // blocks of one (sequence, kv head): a cluster
  int share;                    // cache rows a split holds at most: ceil(T / splits)
  int tiles;                    // BLK-row K (and V) tile buffers: the whole share, or 2
  int wide;                     // 16-byte row copies (D, the row pitch and the bases aligned)
};

// The dynamic shared memory of one block, each region 16-byte aligned.
struct Layout {
  int R, DP, LDT;
  int sc, qw, sq, acc, lmax, psum, inbox, tiles, bytes;
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

__host__ __device__ inline Layout layout(int R, int share, int D, int tiles, int splits) {
  Layout L;
  L.R = R;
  L.DP = (D + 15) & ~15;                            // the dot's padded width
  L.LDT = (L.DP / 16) % 2 == 0 ? L.DP + 16 : L.DP + 32;   // an odd multiple of 16
  L.sc = 0;                                         // [R][share] f32 scores, then int32 pz
  L.qw = L.sc + align16(R * share * 4);             // [R][DP] u8 q, zero padded
  L.sq = L.qw + R * L.DP;                           // [R] int32 sum_d q
  L.acc = L.sq + align16(R * 4);                    // [R][D] int32 P@V partials
  L.lmax = L.acc + align16(R * D * 4);              // [R] f32 local max
  L.psum = L.lmax + align16(R * 4);                 // [R] f64 partial sum
  L.inbox = L.psum + align16(R * 8);                // [R][D] int32: the splits' sums (split 0's)
  L.tiles = L.inbox + (splits > 1 ? align16(R * D * 4) : 0);   // [2][tiles][BLK][LDT] u8 K, V
  L.bytes = L.tiles + 2 * tiles * BLK * L.LDT;
  return L;
}

__device__ __forceinline__ void cp_async(void* smem, const void* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(s), "l"(gmem) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ int clip_trunc(float x, int nearest) {
  x = fminf(fmaxf(x, 0.0f), 255.0f);
  if (nearest) x = __fadd_rn(x, 0.5f);
  return __float2int_rz(x);
}

// rows [t0, t0 + n) of one kv head's D-byte column slice into a tile of
// rows of LDT bytes
__device__ __forceinline__ void load_tile(uint8_t* tile, const uint8_t* base, int C, int D,
                                          int LDT, int t0, int n, bool wide) {
  const int unit = wide ? 16 : 4;
  const int per_row = D / unit;
  for (int i = threadIdx.x; i < n * per_row; i += NTHREADS) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * unit;
    cp_async(tile + r * LDT + c, base + static_cast<size_t>(t0 + r) * C + c, unit);
  }
}

// The cache rows [lo, hi) into consecutive tile buffers (one commit group).
__device__ __forceinline__ void load_rows(const uint8_t* base, const Params& p, const Layout& L,
                                          int lo, int hi, uint8_t* tiles) {
  if (hi > lo) load_tile(tiles, base, p.Hkv * p.D, p.D, L.LDT, lo, hi - lo, p.wide);
  cp_async_commit();
}

// Walk the cache rows [lo, hi) in BLK-row tiles through two buffers, the
// first tile already in flight (load_rows), the next tile's copy in flight
// while the current one is used: compute(tile, t0, n).  For a share longer
// than the block's tile buffers.
template <typename F>
__device__ __forceinline__ void walk(const uint8_t* base, const Params& p, const Layout& L,
                                     int lo, int hi, uint8_t* tiles, F compute) {
  const int C = p.Hkv * p.D;
  const int nt = (hi - lo + BLK - 1) / BLK;
  const int tile_bytes = BLK * L.LDT;
  if (nt <= 0) return;
  for (int it = 0; it < nt; ++it) {
    const int cur = it & 1;
    if (it + 1 < nt) {
      // the buffer written here was last read in iteration it-1, which
      // ended with __syncthreads()
      const int t1 = lo + (it + 1) * BLK;
      load_tile(tiles + (cur ^ 1) * tile_bytes, base, C, p.D, L.LDT, t1, min(BLK, hi - t1),
                p.wide);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int t0 = lo + it * BLK;
    compute(tiles + cur * tile_bytes, t0, min(BLK, hi - t0));
    __syncthreads();
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = __dadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ unsigned dot16(uint4 a, uint4 b, unsigned acc) {
  acc = __dp4a(a.x, b.x, acc);
  acc = __dp4a(a.y, b.y, acc);
  acc = __dp4a(a.z, b.z, acc);
  return __dp4a(a.w, b.w, acc);
}

// Every block of the cluster (or the block alone) at one barrier.
__device__ __forceinline__ void barrier(int splits) {
  if (splits > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

__global__ void __launch_bounds__(NTHREADS) decode_attn_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int splits = p.splits;
  const int split = static_cast<int>(blockIdx.x) % splits;
  const int head = static_cast<int>(blockIdx.x) / splits;
  const int b = head / p.Hkv;
  const int kv = head - b * p.Hkv;
  const int grp = p.H / p.Hkv;
  const int R = p.mq * grp;          // query rows: row r = position r / grp, head kv*grp + r % grp
  const int D = p.D;
  const int T = p.T;
  const int tid = threadIdx.x;
  const Layout L = layout(R, p.share, D, p.tiles, splits);

  float* sc = reinterpret_cast<float*>(smem + L.sc);
  int32_t* pz = reinterpret_cast<int32_t*>(smem + L.sc);
  uint8_t* qw = smem + L.qw;
  int32_t* sq = reinterpret_cast<int32_t*>(smem + L.sq);
  int32_t* acc = reinterpret_cast<int32_t*>(smem + L.acc);
  float* lmax = reinterpret_cast<float*>(smem + L.lmax);
  double* psum = reinterpret_cast<double*>(smem + L.psum);
  int32_t* inbox = reinterpret_cast<int32_t*>(smem + L.inbox);
  uint8_t* tiles = smem + L.tiles;

  const int valid = p.valid[p.valid_per_seq ? b : 0];
  // the live span of all rows: [lo_min, hi_max); row j's is [lo_j, hi_j)
  const int hi_max = min(valid + p.mq - 1, T);
  const int lo_min = p.window >= 0 ? max(valid - p.window, 0) : 0;
  // this split's equal share of the span, [tbeg, tend) (empty past its end)
  const int span = max(hi_max - lo_min, 0);
  const int share = (span + splits - 1) / splits;
  const int tbeg = min(lo_min + split * share, hi_max);
  const int tend = min(tbeg + share, hi_max);
  // K and V in flight together, before anything else: all of the share
  // where the tile buffers hold it (one wait for everything), else its
  // first tiles, the V phase then starting on a tile that landed during the
  // K phase
  const size_t head0 = static_cast<size_t>(b) * T * p.Hkv * D + static_cast<size_t>(kv) * D;
  uint8_t* ktiles = tiles;
  uint8_t* vtiles = tiles + p.tiles * BLK * L.LDT;
  const bool resident = tend - tbeg <= p.tiles * BLK;
  const int first_hi = resident ? tend : min(tend, tbeg + BLK);
  load_rows(p.k + head0, p, L, tbeg, first_hi, ktiles);
  load_rows(p.v + head0, p, L, tbeg, first_hi, vtiles);

  for (int i = tid; i < R * L.DP; i += NTHREADS) {
    const int r = i / L.DP;
    const int d = i - r * L.DP;
    const int h = kv * grp + r % grp;
    qw[i] = d < D ? p.q[b * p.q_sb + (r / grp) * p.q_sj + h * D + d] : 0;
  }
  for (int i = tid; i < R * D; i += NTHREADS) acc[i] = 0;
  if (splits > 1)
    for (int i = tid; i < R * D; i += NTHREADS) inbox[i] = 0;
  // zero the tiles' padding columns [D, DP) once: the dot reads DP bytes a
  // row (the copies write the first D)
  if (L.DP != D) {
    const int pw = (L.DP - D) / 4;
    for (int i = tid; i < 2 * p.tiles * BLK * pw; i += NTHREADS)
      *reinterpret_cast<uint32_t*>(tiles + (i / pw) * L.LDT + D + 4 * (i % pw)) = 0u;
  }
  __syncthreads();
  for (int r = tid; r < R; r += NTHREADS) {
    unsigned s = 0;
    for (int w = 0; w < L.DP / 4; ++w)
      s = __dp4a(*reinterpret_cast<const unsigned*>(qw + r * L.DP + 4 * w), 0x01010101u, s);
    sq[r] = static_cast<int>(s);
  }
  __syncthreads();

  const int zz = D * p.zp_q * p.zp_k;

  // (1) K phase: requantized, dequantized (softcapped) scores of the share
  auto kphase = [&](const uint8_t* tile, int t0, int n) {
    for (int i = tid; i < R * n; i += NTHREADS) {
      const int r = i / n;
      const int tl = i - r * n;
      const uint4* krow = reinterpret_cast<const uint4*>(tile + tl * L.LDT);
      const uint4* qrow = reinterpret_cast<const uint4*>(qw + r * L.DP);
      unsigned qk = 0, sk = 0;
      for (int w = 0; w < L.DP / 16; ++w) {
        const uint4 kv4 = krow[w];
        qk = dot16(qrow[w], kv4, qk);
        sk = dot16(make_uint4(0x01010101u, 0x01010101u, 0x01010101u, 0x01010101u), kv4, sk);
      }
      const int s = static_cast<int>(qk) - p.zp_k * sq[r] - p.zp_q * static_cast<int>(sk) + zz;
      const int code = clip_trunc(__fadd_rn(__fmul_rn(__int2float_rn(s), p.mult_s), p.zp_s),
                                  p.nearest);
      float f = __fmul_rn(__fsub_rn(__int2float_rn(code), p.zp_s), p.s_s);
      if (p.softcap > 0.0f) f = __fmul_rn(p.softcap, tanhf(__fdiv_rn(f, p.softcap)));
      sc[r * p.share + (t0 + tl - tbeg)] = f;
    }
  };
  if (resident) {
    cp_async_wait<1>();              // the K rows (the V rows may still be in flight)
    __syncthreads();
    kphase(ktiles, tbeg, tend - tbeg);
    __syncthreads();
  } else {
    walk(p.k + head0, p, L, tbeg, tend, ktiles, kphase);
  }

  // each warp takes whole rows; row r's columns in this share are [a, e)
  const int warp = tid >> 5;
  const int lane = tid & 31;
  auto horizon = [&](int r, int& a, int& e) {
    const int j = r / grp;
    const int hi = min(valid + j, T);
    const int lo = p.window >= 0 ? max(valid + j - p.window, 0) : 0;
    a = max(lo, tbeg);
    e = min(hi, tend);
  };
  for (int r = warp; r < R; r += NTHREADS / 32) {
    int a, e;
    horizon(r, a, e);
    const float* row = sc + r * p.share - tbeg;   // indexed by cache position
    float m = -__int_as_float(0x7f800000);        // -inf: no column of row r here
    for (int t = a + lane; t < e; t += 32) m = fmaxf(m, row[t]);
    m = warp_max(m);
    if (lane == 0) lmax[r] = m;
  }
  // (2) the max over the splits, exact in any order
  barrier(splits);
  for (int r = warp; r < R; r += NTHREADS / 32) {
    float m = -__int_as_float(0x7f800000);
    if (lane < splits) {
      const float* other = splits > 1 ? cg::this_cluster().map_shared_rank(lmax, lane) : lmax;
      m = other[r];
    }
    m = warp_max(m);
    int a, e;
    horizon(r, a, e);
    float* row = sc + r * p.share - tbeg;
    // (3) the exps and their float64 partial sum
    double sum_d = 0.0;
    for (int t = a + lane; t < e; t += 32) {
      // exp in double, rounded once (ops/functional.rounded64)
      const float ex = static_cast<float>(exp(static_cast<double>(__fsub_rn(row[t], m))));
      row[t] = ex;
      sum_d = __dadd_rn(sum_d, static_cast<double>(ex));
    }
    sum_d = warp_sum(sum_d);
    if (lane == 0) psum[r] = sum_d;
  }
  barrier(splits);
  for (int r = warp; r < R; r += NTHREADS / 32) {
    // the denominator: the splits' partials added in split order, rounded
    // once, the same in every block
    double sum_d = 0.0;
    for (int i = 0; i < splits; ++i) {
      const double* other = splits > 1 ? cg::this_cluster().map_shared_rank(psum, i) : psum;
      sum_d = __dadd_rn(sum_d, other[r]);
    }
    const float sum = __double2float_rn(sum_d);
    int a, e;
    horizon(r, a, e);
    float* row = sc + r * p.share - tbeg;
    int32_t* prow = pz + r * p.share - tbeg;
    // (4) probabilities requantized: pz = code - zp_p over the whole share
    // (masked columns: 0)
    for (int t = tbeg + lane; t < tend; t += 32) {
      int z = 0;
      if (t >= a && t < e) {
        const float pr = __fdiv_rn(row[t], sum);
        z = clip_trunc(__fadd_rn(__fdiv_rn(pr, p.s_p), p.zp_pf), p.nearest) - p.zp_p;
      }
      prow[t] = z;
    }
  }
  __syncthreads();

  // V phase: exact int32 sums of pz * (v - zp_v) per (row, d); a thread
  // takes four d of one row, and where the rows x D/4 are fewer than the
  // threads, groups of threads take every TG-th cache row
  const int D4 = D / 4;
  const int E = R * D4;
  const int TG = E < NTHREADS ? NTHREADS / E : 1;
  const int tg = tid / E;
  auto vphase = [&](const uint8_t* tile, int t0, int n) {
    if (tg >= TG) return;
    for (int ei = tid - tg * E; ei < E; ei += TG == 1 ? NTHREADS : E) {
      const int r = ei / D4;
      const int d = 4 * (ei - r * D4);
      const int32_t* prow = pz + r * p.share + (t0 - tbeg);
      int a0 = 0, a1 = 0, a2 = 0, a3 = 0, ps = 0;
      for (int tl = tg; tl < n; tl += TG) {
        const int z = prow[tl];
        const uint32_t w = *reinterpret_cast<const uint32_t*>(tile + tl * L.LDT + d);
        a0 += z * static_cast<int>(w & 0xffu);
        a1 += z * static_cast<int>((w >> 8) & 0xffu);
        a2 += z * static_cast<int>((w >> 16) & 0xffu);
        a3 += z * static_cast<int>(w >> 24);
        ps += z;
      }
      const int zv = p.zp_v * ps;
      int32_t* out = acc + r * D + d;
      if (TG > 1) {
        atomicAdd(out, a0 - zv);
        atomicAdd(out + 1, a1 - zv);
        atomicAdd(out + 2, a2 - zv);
        atomicAdd(out + 3, a3 - zv);
      } else {
        out[0] += a0 - zv;
        out[1] += a1 - zv;
        out[2] += a2 - zv;
        out[3] += a3 - zv;
      }
    }
  };
  if (resident) {
    cp_async_wait<0>();
    __syncthreads();
    vphase(vtiles, tbeg, tend - tbeg);
  } else {
    walk(p.v + head0, p, L, tbeg, tend, vtiles, vphase);
  }

  // (5) every split adds its int32 partials into split 0's inbox through
  // distributed shared memory (exact in any order); one barrier later
  // split 0 requantizes each output once
  __syncthreads();
  const int32_t* sums = acc;
  if (splits > 1) {
    int32_t* dst = cg::this_cluster().map_shared_rank(inbox, 0);
    for (int i = tid; i < R * D; i += NTHREADS) atomicAdd(dst + i, acc[i]);
    cg::this_cluster().sync();
    if (split != 0) return;
    sums = inbox;
  }
  for (int i = tid; i < R * D; i += NTHREADS) {
    const int s = sums[i];
    const int r = i / D;
    const int d = i - r * D;
    const int h = kv * grp + r % grp;
    const int code = clip_trunc(__fadd_rn(__fmul_rn(__int2float_rn(s), p.mult_o), p.zp_c),
                                p.nearest);
    p.out[(static_cast<size_t>(b) * p.mq + r / grp) * (p.H * D) + h * D + d] =
        static_cast<uint8_t>(code);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 when the launch was
// accepted).  Pointers are device pointers; the caller checks shapes,
// dtypes, contiguity and 4-byte alignment.  `splits`, `share` and `tiles`
// are the plan of ops/attention.plan_decode_attn (a cluster of `splits`
// blocks per (sequence, kv head), each holding at most `share` = ceil(T /
// splits) cache rows, in `tiles` 64-row K and V buffers: the whole share,
// or two to stream it); a plan this file cannot run is refused with
// cudaErrorInvalidValue.
extern "C" int decode_attn_flat(const void* q, const void* k, const void* v, const void* valid,
                                void* out, int B, int T, int H, int Hkv, int D, int mq,
                                long long q_sb, long long q_sj, int valid_per_seq, int window,
                                float softcap, int zp_q, int zp_k, int zp_p, int zp_v,
                                float mult_s, float zp_s, float s_s, float s_p, float zp_pf,
                                float mult_o, float zp_c, int nearest, int splits, int share,
                                int tiles, void* stream) {
  if (B <= 0 || T <= 0 || Hkv <= 0 || H % Hkv || D % 4 || D <= 0 || mq <= 0 || splits < 1 ||
      splits > MAX_SPLITS || share != (T + splits - 1) / splits || tiles < 1 ||
      (tiles < 2 && share > BLK) || static_cast<long long>(B) * Hkv * splits >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int R = mq * (H / Hkv);
  const Layout L = layout(R, share, D, tiles, splits);
  if (L.bytes > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int C = Hkv * D;
  const int wide = D % 16 == 0 && C % 16 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const cudaError_t attr = cudaFuncSetAttribute(
      decode_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const Params p{static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(k),
                 static_cast<const uint8_t*>(v), static_cast<const int32_t*>(valid),
                 static_cast<uint8_t*>(out), T, H, Hkv, D, mq, q_sb, q_sj, valid_per_seq,
                 window, softcap, zp_q, zp_k, zp_p, zp_v, mult_s, zp_s, s_s, s_p, zp_pf,
                 mult_o, zp_c, nearest, splits, share, tiles, wide};
  if (splits == 1) {
    decode_attn_kernel<<<B * Hkv, NTHREADS, L.bytes, static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = splits;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * Hkv * splits);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, decode_attn_kernel, p);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

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
//   p       = expf(f - max) / f32(sum_f64 expf(f - max))
//   pz      = trunc(clip(p / s_p + zp_p) [+0.5]) - zp_p    (masked: exactly 0)
//   out     = trunc(clip(f32(sum_t pz * (v - zp_v)) * mult_o + zp_c) [+0.5])
//
// Both dot products are exact int32 sums.  The float steps are explicitly
// rounded intrinsics in the composed order (the file builds with
// --fmad=false).  The softmax denominator accumulates in double and rounds
// once, as ops/attention.softmax_last does: the correctly rounded float32
// sum, so the warp's add order does not matter (a float32 sum in another
// order flips a probability code sitting on a truncation boundary, and a
// decode carries that code on through its KV cache).  Only expf and tanhf
// may differ from another libm by an ULP.
//
// Replaces the TPU kernels int8inferenceengine_tpu/ops/attention.py
// ::_decode_attn_kernel_flat_merged and ::_decode_attn_kernel_flat (both
// launched by _decode_attn_flat_impl; merged=True/False compute the same
// function).  Their bf16/f32 dot tricks and block-diagonal query operand work
// around the TPU's MXU and are not carried over.
//
// What bounds it on an H100: the bytes of the live cache rows (2 * live * D
// per (sequence, kv head)), a few MB per decode step, against a fixed cost
// of a dependent chain (K phase -> softmax -> V phase) in each block.
// Design: one block of 128 threads per (sequence, kv head) holds that
// head group's mq * (H / Hkv) query rows and walks only the live rows
// [lo, hi) of its kv head's D-byte slice of the cache in 64-row tiles,
// double-buffered with 4-byte cp.async (coalesced: neighbouring threads
// read neighbouring words of a row) into shared memory rows padded to D + 4
// bytes, so that the one-column-per-thread dot reads hit distinct banks.
// The scores of the live span stay in shared memory (rows * T * 4 bytes, the
// wrapper refuses more than the block can hold); each warp takes whole rows
// for the softmax; the P@V sums keep one int32 per (row, d) in shared
// memory.  Split-T across blocks (flash decoding) and tensor-core dots are
// later work.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int BLK = 64;         // cache rows per tile (ops/attention.py _BLK)
constexpr int NTHREADS = 128;

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
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
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
// rows padded to D + 4 bytes
__device__ __forceinline__ void load_tile(uint8_t* tile, const uint8_t* base, int C, int D,
                                          int t0, int n) {
  const int words = D / 4;
  for (int i = threadIdx.x; i < n * words; i += NTHREADS) {
    const int r = i / words;
    const int w = i - r * words;
    cp_async4(tile + r * (D + 4) + 4 * w, base + static_cast<size_t>(t0 + r) * C + 4 * w);
  }
}

// Walk the cache rows [lo, hi) in BLK-row tiles, the next tile's copy in
// flight while the current one is used: compute(tile, t0, n).
template <typename F>
__device__ __forceinline__ void walk(const uint8_t* base, int C, int D, int lo, int hi,
                                     uint8_t* tiles, F compute) {
  const int nt = (hi - lo + BLK - 1) / BLK;
  const int tile_bytes = BLK * (D + 4);
  if (nt <= 0) return;
  load_tile(tiles, base, C, D, lo, min(BLK, hi - lo));
  cp_async_commit();
  for (int it = 0; it < nt; ++it) {
    const int cur = it & 1;
    if (it + 1 < nt) {
      // the buffer written here was last read in iteration it-1, which
      // ended with __syncthreads()
      const int t1 = lo + (it + 1) * BLK;
      load_tile(tiles + (cur ^ 1) * tile_bytes, base, C, D, t1, min(BLK, hi - t1));
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

__global__ void __launch_bounds__(NTHREADS) decode_attn_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / p.Hkv;
  const int kv = blockIdx.x - b * p.Hkv;
  const int grp = p.H / p.Hkv;
  const int R = p.mq * grp;          // query rows: row r = position r / grp, head kv*grp + r % grp
  const int D = p.D;
  const int C = p.Hkv * D;
  const int T = p.T;
  const int tid = threadIdx.x;

  float* sc = reinterpret_cast<float*>(smem);                    // [R][T] scores, then pz
  int32_t* qs = reinterpret_cast<int32_t*>(sc + R * T);          // [R][D] q - zp_q
  int32_t* acc = qs + R * D;                                     // [R][D] P@V sums
  uint8_t* tiles = reinterpret_cast<uint8_t*>(acc + R * D);      // [2][BLK][D + 4]

  const int valid = p.valid[p.valid_per_seq ? b : 0];
  // the live span of all rows: [lo_min, hi_max); row j's is [lo_j, hi_j)
  const int hi_max = min(valid + p.mq - 1, T);
  const int lo_min = p.window >= 0 ? max(valid - p.window, 0) : 0;

  for (int i = tid; i < R * D; i += NTHREADS) {
    const int r = i / D;
    const int d = i - r * D;
    const int h = kv * grp + r % grp;
    qs[i] = static_cast<int>(p.q[b * p.q_sb + (r / grp) * p.q_sj + h * D + d]) - p.zp_q;
    acc[i] = 0;
  }

  const size_t head0 = static_cast<size_t>(b) * T * C + static_cast<size_t>(kv) * D;

  // K phase: requantized, dequantized (softcapped) scores of the live span
  walk(p.k + head0, C, D, lo_min, hi_max, tiles, [&](const uint8_t* tile, int t0, int n) {
    for (int i = tid; i < R * BLK; i += NTHREADS) {
      const int r = i / BLK;
      const int tl = i - r * BLK;
      if (tl >= n) continue;
      const uint32_t* krow = reinterpret_cast<const uint32_t*>(tile + tl * (D + 4));
      const int32_t* qr = qs + r * D;
      int s = 0;
      for (int w = 0; w < D / 4; ++w) {
        const uint32_t kw = krow[w];
        s += qr[4 * w] * (static_cast<int>(kw & 0xffu) - p.zp_k);
        s += qr[4 * w + 1] * (static_cast<int>((kw >> 8) & 0xffu) - p.zp_k);
        s += qr[4 * w + 2] * (static_cast<int>((kw >> 16) & 0xffu) - p.zp_k);
        s += qr[4 * w + 3] * (static_cast<int>(kw >> 24) - p.zp_k);
      }
      const int code = clip_trunc(__fadd_rn(__fmul_rn(__int2float_rn(s), p.mult_s), p.zp_s),
                                  p.nearest);
      float f = __fmul_rn(__fsub_rn(__int2float_rn(code), p.zp_s), p.s_s);
      if (p.softcap > 0.0f) f = __fmul_rn(p.softcap, tanhf(__fdiv_rn(f, p.softcap)));
      sc[r * T + (t0 + tl - lo_min)] = f;
    }
  });

  // softmax of each row over its own horizon; probabilities requantized and
  // stored as pz = code - zp_p over the whole span (masked columns: 0)
  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int r = warp; r < R; r += NTHREADS / 32) {
    const int j = r / grp;
    const int hi = min(valid + j, T);
    const int lo = p.window >= 0 ? max(valid + j - p.window, 0) : 0;
    float* row = sc + r * T - lo_min;             // indexed by cache position
    float m = -__int_as_float(0x7f800000);   // -inf
    for (int t = lo + lane; t < hi; t += 32) m = fmaxf(m, row[t]);
    m = warp_max(m);
    // the denominator in float64, rounded once: the correctly rounded
    // float32 sum in any order, as ops/attention.softmax_last takes it
    double sum_d = 0.0;
    for (int t = lo + lane; t < hi; t += 32) {
      const float e = expf(__fsub_rn(row[t], m));
      row[t] = e;
      sum_d = __dadd_rn(sum_d, static_cast<double>(e));
    }
    const float sum = __double2float_rn(warp_sum(sum_d));
    __syncwarp();
    for (int t = lo_min + lane; t < hi_max; t += 32) {
      float pz = 0.0f;
      if (t >= lo && t < hi) {
        const float pr = __fdiv_rn(row[t], sum);
        pz = static_cast<float>(
            clip_trunc(__fadd_rn(__fdiv_rn(pr, p.s_p), p.zp_pf), p.nearest) - p.zp_p);
      }
      row[t] = pz;
    }
  }
  __syncthreads();

  // V phase: exact int32 sums of pz * (v - zp_v) per (row, d)
  walk(p.v + head0, C, D, lo_min, hi_max, tiles, [&](const uint8_t* tile, int t0, int n) {
    for (int i = tid; i < R * D; i += NTHREADS) {
      const int r = i / D;
      const int d = i - r * D;
      const float* pr = sc + r * T + (t0 - lo_min);
      int a = acc[i];
      for (int tl = 0; tl < n; ++tl) {
        a += static_cast<int>(pr[tl]) * (static_cast<int>(tile[tl * (D + 4) + d]) - p.zp_v);
      }
      acc[i] = a;
    }
  });

  for (int i = tid; i < R * D; i += NTHREADS) {
    const int r = i / D;
    const int d = i - r * D;
    const int h = kv * grp + r % grp;
    const int code = clip_trunc(__fadd_rn(__fmul_rn(__int2float_rn(acc[i]), p.mult_o), p.zp_c),
                                p.nearest);
    p.out[(static_cast<size_t>(b) * p.mq + r / grp) * (p.H * D) + h * D + d] =
        static_cast<uint8_t>(code);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 when the launch was
// accepted).  Pointers are device pointers; the caller checks shapes,
// dtypes, contiguity, 4-byte alignment and the shared-memory size.
extern "C" int decode_attn_flat(const void* q, const void* k, const void* v, const void* valid,
                                void* out, int B, int T, int H, int Hkv, int D, int mq,
                                long long q_sb, long long q_sj, int valid_per_seq, int window,
                                float softcap, int zp_q, int zp_k, int zp_p, int zp_v,
                                float mult_s, float zp_s, float s_s, float s_p, float zp_pf,
                                float mult_o, float zp_c, int nearest, int smem_bytes,
                                void* stream) {
  if (B <= 0 || T <= 0 || Hkv <= 0 || H % Hkv || D % 4 || mq <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const Params p{static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(k),
                 static_cast<const uint8_t*>(v), static_cast<const int32_t*>(valid),
                 static_cast<uint8_t*>(out), T, H, Hkv, D, mq, q_sb, q_sj, valid_per_seq,
                 window, softcap, zp_q, zp_k, zp_p, zp_v, mult_s, zp_s, s_s, s_p, zp_pf,
                 mult_o, zp_c, nearest};
  decode_attn_kernel<<<B * Hkv, NTHREADS, smem_bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Grouped (depthwise) quantized convolution, kernel G1, for Hopper (sm_90a):
//
//   out[b, oh, ow, o] = requant( sum_{l, m, ci} (x[b, ih, iw, g*Cg + ci] - 128)
//                                  * w[o, (l * kw + m) * Cg + ci]  +  oc[o] )
//
// with g = o / (O / groups) the output channel's group, Cg = C / groups,
// ih = oh * stride - pad + l, iw = ow * stride - pad + m, and a tap outside
// the image reading the activation zero point zp_a (the reference's
// padding).  x is u8 NHWC [B, H, W, C], w is s8 [O, kh * kw * Cg] (the
// port's stored weight layout, taps (kh, kw, Cg)), oc is s32 [O] and
// already carries the zero-point correction, the +128 recentering term
// over the channel's own group taps and the folded bias
// (ops/gemm_int8.py compute_offset(..., recentered=True)), ep is the f32
// [O] weight scale s_w.  The epilogue is the conv float order of the
// reference's down_scale, as B1's conv epilogue:
//
//   q = ((f32(acc + oc) * s_a) * s_w[o]) / s_c + zp_c
//
// then clip to [0, 255], +0.5 under 'nearest', truncate, max(., zp_c) under
// relu.  Every float step is an explicitly rounded intrinsic and the file
// is built with --fmad=false, so the codes are bit-identical to the plain
// version (ops/conv.py conv2d_int8_grouped_plain).  A second instance of
// each kernel (bf16 = 1, QuantConfig.epilogue_dtype 'bfloat16') runs B1's
// bfloat16 conv epilogue instead, ep then the bfloat16 multiplier:
//
//   q = bf16(bf16(bf16(f32(acc + oc)) * mult[o]) + zp_c), clip, + 0.5
//       rounded to bf16 under 'nearest', truncate, at most 255
//
// each op in float and rounded to bfloat16 nearest-even, as
// ops/quant.requant_bf16 (PyTorch's bfloat16 arithmetic) does.
//
// No TPU kernel: the JAX package runs grouped convs on XLA's native integer
// convolution (int8inferenceengine_tpu/ops/conv.py conv2d_int8_xla with
// feature_group_count; layers.py sends every groups > 1 conv there).  PyTorch
// has no CUDA int8 convolution, and a depthwise conv as B1's GEMM has one
// output column a group, so this kernel stands in for XLA's.
//
// What bounds it on an H100: a depthwise conv does 2 * k * k operations a
// output byte and reads each input byte about once, so it is bound by its
// bytes at 3.35 TB/s (MobileNetV2's widest depthwise layer at batch 100
// moves ~0.15 GB: ~45 us).  Design (a simple kernel that is right first): a
// thread computes one output pixel's run of 4 adjacent output channels;
// neighbouring threads take neighbouring runs of the same pixel, so a warp's
// loads of a tap are one contiguous run of the NHWC row.
//   * depthwise (Cg = 1, one output a group) with C % 4 == 0: each tap is
//     one 4-byte load of the 4 channels, recentered by XOR 0x80 on each
//     byte, and 4 integer multiply-adds against the 4 channels' weights;
//   * Cg % 4 == 0 (and C % 4 == 0): each output channel's taps walk its
//     group's channels in 4-byte words with __dp4a;
//   * any other shape (C % 4 != 0, as ShuffleNetV2's 58 channels; channel
//     multipliers; Cg = 2, 3): bytes.
// The launcher picks the first path the shape and the operands' alignment
// allow.  Tensor cores, shared-memory tiles of the input and a depthwise
// weight layout are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 4;  // output channels a thread

struct Params {
  const uint8_t* x;  // u8 NHWC [B, H, W, C]
  const int8_t* w;   // s8 [O, kh * kw * Cg]
  const int32_t* oc;
  const float* sw;
  uint8_t* out;  // u8 NHWC [B, OH, OW, O]
  int B, H, W, C, O, cg, og, kh, kw, stride, pad, OH, OW, runs;
  int total;  // output pixels x runs (< 2^31: the launcher checks)
  int zp_a;
  uint32_t zp4;  // zp_a in each byte
  float s_a, s_c, zp_f;
  int zp_c, relu, nearest;
};

__device__ __forceinline__ int clip_trunc(float q, int nearest) {
  q = fminf(fmaxf(q, 0.0f), 255.0f);
  if (nearest) q = __fadd_rn(q, 0.5f);
  return __float2int_rz(q);
}

// float -> the nearest-even bfloat16, back in float
__device__ __forceinline__ float bf16_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the conv-order epilogue of one output channel (kBf16: its bfloat16 form)
template <bool kBf16>
__device__ __forceinline__ uint32_t requant(int32_t acc, int o, const Params& p) {
  // s32 wrap-around add, as the reference's int32 arrays do
  const int32_t c = static_cast<int32_t>(static_cast<uint32_t>(acc) +
                                         static_cast<uint32_t>(p.oc[o]));
  if constexpr (kBf16) {
    float q = bf16_rn(__fadd_rn(bf16_rn(__fmul_rn(bf16_rn(__int2float_rn(c)), p.sw[o])),
                                p.zp_f));
    q = fminf(fmaxf(q, 0.0f), 255.0f);
    if (p.nearest) q = bf16_rn(__fadd_rn(q, 0.5f));
    int qi = min(__float2int_rz(q), 255);  // 255.5 rounds to 256: saturate
    if (p.relu) qi = max(qi, p.zp_c);
    return static_cast<uint32_t>(qi);
  }
  const float q = __fadd_rn(
      __fdiv_rn(__fmul_rn(__fmul_rn(__int2float_rn(c), p.s_a), p.sw[o]), p.s_c), p.zp_f);
  int qi = clip_trunc(q, p.nearest);
  if (p.relu) qi = max(qi, p.zp_c);
  return static_cast<uint32_t>(qi);
}

// The output pixel and the first output channel of thread t
// (32-bit index arithmetic: a 64-bit division costs tens of instructions)
struct Site {
  int pix;  // (b * OH + oh) * OW + ow
  int b, ih0, iw0, o0;
};

__device__ __forceinline__ Site site_of(int t, const Params& p) {
  Site s;
  const int run = t % p.runs;
  s.pix = t / p.runs;
  const int ow = s.pix % p.OW;
  const int r = s.pix / p.OW;
  const int oh = r % p.OH;
  s.b = r / p.OH;
  s.ih0 = oh * p.stride - p.pad;
  s.iw0 = ow * p.stride - p.pad;
  s.o0 = run * kRun;
  return s;
}

// The input row of tap (ih, iw), or null where the tap is padding
__device__ __forceinline__ const uint8_t* tap_row(const Site& s, int ih, int iw,
                                                  const Params& p) {
  if (static_cast<unsigned>(ih) >= static_cast<unsigned>(p.H) ||
      static_cast<unsigned>(iw) >= static_cast<unsigned>(p.W))
    return nullptr;
  return p.x + ((static_cast<size_t>(s.b) * p.H + ih) * p.W + iw) * p.C;
}

// Depthwise, C % 4 == 0: four channels a 4-byte word
template <bool kBf16>
__global__ void __launch_bounds__(kThreads) dw_word_kernel(Params p) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= p.total) return;
  const Site s = site_of(t, p);
  const int taps = p.kh * p.kw;
  const int8_t* w = p.w + static_cast<size_t>(s.o0) * taps;
  int acc[kRun] = {0, 0, 0, 0};
  for (int l = 0; l < p.kh; ++l) {
    for (int m = 0; m < p.kw; ++m) {
      const uint8_t* row = tap_row(s, s.ih0 + l, s.iw0 + m, p);
      const uint32_t v =
          (row ? __ldg(reinterpret_cast<const uint32_t*>(row + s.o0)) : p.zp4) ^ 0x80808080u;
      const int tap = l * p.kw + m;
#pragma unroll
      for (int j = 0; j < kRun; ++j)
        acc[j] += static_cast<int>(static_cast<int8_t>(v >> (8 * j))) *
                  static_cast<int>(__ldg(w + j * taps + tap));
    }
  }
  uint32_t packed = 0;
#pragma unroll
  for (int j = 0; j < kRun; ++j) packed |= requant<kBf16>(acc[j], s.o0 + j, p) << (8 * j);
  *reinterpret_cast<uint32_t*>(p.out + static_cast<size_t>(s.pix) * p.O + s.o0) = packed;
}

// Any grouping; kWords: Cg % 4 == 0 and C % 4 == 0, each channel's taps in
// 4-byte words through __dp4a; else bytes
template <bool kWords, bool kBf16>
__global__ void __launch_bounds__(kThreads) grouped_kernel(Params p) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= p.total) return;
  const Site s = site_of(t, p);
  const int k = p.kh * p.kw * p.cg;
  uint8_t* dst = p.out + static_cast<size_t>(s.pix) * p.O;
  for (int j = 0; j < kRun && s.o0 + j < p.O; ++j) {
    const int o = s.o0 + j;
    const int cb = (o / p.og) * p.cg;  // the group's first input channel
    const int8_t* w = p.w + static_cast<size_t>(o) * k;
    int acc = 0;
    for (int l = 0; l < p.kh; ++l) {
      for (int m = 0; m < p.kw; ++m) {
        const uint8_t* row = tap_row(s, s.ih0 + l, s.iw0 + m, p);
        const int8_t* wt = w + (l * p.kw + m) * p.cg;
        if constexpr (kWords) {
          for (int ci = 0; ci < p.cg; ci += 4) {
            const uint32_t v =
                (row ? __ldg(reinterpret_cast<const uint32_t*>(row + cb + ci)) : p.zp4) ^
                0x80808080u;
            acc = __dp4a(static_cast<int>(v),
                         __ldg(reinterpret_cast<const int*>(wt + ci)), acc);
          }
        } else {
          for (int ci = 0; ci < p.cg; ++ci) {
            const int a = row ? static_cast<int>(__ldg(row + cb + ci)) : p.zp_a;
            acc += (a - 128) * static_cast<int>(__ldg(wt + ci));
          }
        }
      }
    }
    dst[o] = static_cast<uint8_t>(requant<kBf16>(acc, o, p));
  }
}

bool aligned4(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 4 == 0; }

// The first path the shape and the operands' alignment allow
template <bool kBf16>
void launch(const Params& p, const dim3 grid, bool words, bool out4, cudaStream_t s) {
  if (p.cg == 1 && p.og == 1 && words && out4) {
    dw_word_kernel<kBf16><<<grid, kThreads, 0, s>>>(p);
  } else if (p.cg % 4 == 0 && words) {
    grouped_kernel<true, kBf16><<<grid, kThreads, 0, s>>>(p);
  } else {
    grouped_kernel<false, kBf16><<<grid, kThreads, 0, s>>>(p);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 when the launch was
// accepted).  x is u8 NHWC [B, H, W, C], w s8 [O, kh * kw * C / groups], oc
// s32 [O], ep f32 [O] (s_w, or under bf16 the bfloat16 multiplier), out u8
// NHWC [B, OH, OW, O]; all device
// pointers, contiguous, checked by the caller (ops/conv.py
// conv2d_int8_grouped).  The input and the output must hold fewer than 2^31
// bytes.
extern "C" int conv_grouped_u8s8(const void* x, const void* w, const void* oc, const void* ep,
                                 void* out, int B, int H, int W, int C, int O, int groups,
                                 int kh, int kw, int stride, int pad, int zp_a, float s_a,
                                 float s_c, int zp_c, int relu, int nearest, int bf16,
                                 void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || O <= 0 || groups <= 0 || C % groups ||
      O % groups || kh <= 0 || kw <= 0 || stride <= 0 || pad < 0 || H + 2 * pad < kh ||
      W + 2 * pad < kw || zp_a < 0 || zp_a > 255 ||
      static_cast<long long>(B) * H * W * C >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.x = static_cast<const uint8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.oc = static_cast<const int32_t*>(oc);
  p.sw = static_cast<const float*>(ep);
  p.out = static_cast<uint8_t*>(out);
  p.B = B;
  p.H = H;
  p.W = W;
  p.C = C;
  p.O = O;
  p.cg = C / groups;
  p.og = O / groups;
  p.kh = kh;
  p.kw = kw;
  p.stride = stride;
  p.pad = pad;
  p.OH = (H + 2 * pad - kh) / stride + 1;
  p.OW = (W + 2 * pad - kw) / stride + 1;
  p.runs = (O + kRun - 1) / kRun;
  const long long pixels = static_cast<long long>(B) * p.OH * p.OW;
  if (pixels * O >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  p.total = static_cast<int>(pixels * p.runs);
  p.zp_a = zp_a;
  p.zp4 = 0x01010101u * static_cast<uint32_t>(zp_a);
  p.s_a = s_a;
  p.s_c = s_c;
  p.zp_f = static_cast<float>(zp_c);
  p.zp_c = zp_c;
  p.relu = relu;
  p.nearest = nearest;
  const dim3 grid(static_cast<unsigned>((p.total + kThreads - 1) / kThreads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool words = C % 4 == 0 && aligned4(x) && aligned4(w);
  if (bf16) {
    launch<true>(p, grid, words, aligned4(out), s);
  } else {
    launch<false>(p, grid, words, aligned4(out), s);
  }
  return static_cast<int>(cudaGetLastError());
}

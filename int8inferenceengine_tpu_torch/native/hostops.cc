// Host-side native ops: preprocessing, quantization, layout conversion.
//
// The PyTorch port's copy of the JAX package's host ops
// (int8inferenceengine_tpu/native/hostops.cc), code unchanged, so that the
// two libraries built with the same flags on the same machine give the same
// bytes.  The compute runs on the card; what stays on the host is the I/O
// path that feeds it: image preprocessing (resize + normalize, the AlexNet
// notebook's input pipeline), input quantization and the first conv's
// space-to-depth pre-layout.  Quantizing on the host means the copy to the
// card moves u8 instead of f32 (4x fewer bytes), and the prefetching data
// loader (data.py) overlaps it with the card's work.
//
// Plain C ABI (loaded with ctypes).  OpenMP parallel over the batch
// dimension.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstddef>

extern "C" {

// Asymmetric affine quantization f32 -> u8:
//   q = (uint8)clip(x/scale + zp, 0, 255), trunc toward zero
// (reference: src/quantize_utils.cc:3-10).  NOTE: a true division, not
// multiplication by the reciprocal — the device path (ops/quant.quantize_u8)
// divides, and the 1-LSB divergence of x*(1/s) would break the host-vs-
// device bit-equality contract (~1e-6/element observed at scale 0.025).
void i8ie_quantize_u8(const float* x, int64_t n, float scale, int32_t zp,
                      uint8_t* out) {
  const float zpf = (float)zp;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    float t = x[i] / scale + zpf;
    t = std::min(255.0f, std::max(0.0f, t));
    out[i] = (uint8_t)t;
  }
}

// Dequantization u8 -> f32: x = (q - zp) * scale
// (reference: src/quantize_utils.cc:38-42).
void i8ie_dequantize_u8(const uint8_t* q, int64_t n, float scale, int32_t zp,
                        float* out) {
  const float zpf = (float)zp;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    out[i] = ((float)q[i] - zpf) * scale;
  }
}

// Per-channel normalize + layout: u8 HWC images -> f32 NCHW
//   out[n,c,h,w] = (img[n,h,w,c]/255 - mean[c]) / std[c]
// The AlexNet notebook's torchvision ToTensor+Normalize pipeline
// (AlexNet_cifar10_resize224.ipynb cell 1) as one native pass.
void i8ie_normalize_nchw(const uint8_t* img, int64_t n, int64_t h, int64_t w,
                         int64_t c, const float* mean, const float* stddev,
                         float* out) {
  const int64_t hw = h * w;
  const int64_t chw = c * hw;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* src = img + i * hw * c;
    float* dst = out + i * chw;
    for (int64_t ch = 0; ch < c; ++ch) {
      const float m = mean[ch], inv_s = 1.0f / stddev[ch];
      float* plane = dst + ch * hw;
      for (int64_t p = 0; p < hw; ++p) {
        plane[p] = ((float)src[p * c + ch] * (1.0f / 255.0f) - m) * inv_s;
      }
    }
  }
}

// Bilinear resize, u8 HWC -> u8 HWC (align_corners=false, the
// torchvision/PIL convention used by the notebooks' Resize(224)).
void i8ie_resize_bilinear(const uint8_t* img, int64_t n, int64_t h,
                          int64_t w, int64_t c, int64_t oh, int64_t ow,
                          uint8_t* out) {
  const float sy = (float)h / (float)oh;
  const float sx = (float)w / (float)ow;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* src = img + i * h * w * c;
    uint8_t* dst = out + i * oh * ow * c;
    for (int64_t y = 0; y < oh; ++y) {
      float fy = ((float)y + 0.5f) * sy - 0.5f;
      fy = std::max(0.0f, std::min((float)(h - 1), fy));
      int64_t y0 = (int64_t)fy;
      int64_t y1 = std::min(h - 1, y0 + 1);
      float wy = fy - (float)y0;
      for (int64_t x = 0; x < ow; ++x) {
        float fx = ((float)x + 0.5f) * sx - 0.5f;
        fx = std::max(0.0f, std::min((float)(w - 1), fx));
        int64_t x0 = (int64_t)fx;
        int64_t x1 = std::min(w - 1, x0 + 1);
        float wx = fx - (float)x0;
        for (int64_t ch = 0; ch < c; ++ch) {
          float v00 = src[(y0 * w + x0) * c + ch];
          float v01 = src[(y0 * w + x1) * c + ch];
          float v10 = src[(y1 * w + x0) * c + ch];
          float v11 = src[(y1 * w + x1) * c + ch];
          float top = v00 + (v01 - v00) * wx;
          float bot = v10 + (v11 - v10) * wx;
          float v = top + (bot - top) * wy;
          dst[(y * ow + x) * c + ch] = (uint8_t)(v + 0.5f);
        }
      }
    }
  }
}

// Fused inference ingest: u8 HWC -> normalize -> quantize -> u8 NCHW at the
// model's input (scale, zp).  One pass, no f32 batch materialized; the
// device receives 1/4 the bytes of the f32 pipeline.
void i8ie_preprocess_quantize(const uint8_t* img, int64_t n, int64_t h,
                              int64_t w, int64_t c, const float* mean,
                              const float* stddev, float scale, int32_t zp,
                              uint8_t* out) {
  const int64_t hw = h * w;
  const int64_t chw = c * hw;
  const float zpf = (float)zp;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* src = img + i * hw * c;
    uint8_t* dst = out + i * chw;
    for (int64_t ch = 0; ch < c; ++ch) {
      const float m = mean[ch], inv_s = 1.0f / stddev[ch];
      uint8_t* plane = dst + ch * hw;
      for (int64_t p = 0; p < hw; ++p) {
        float v = ((float)src[p * c + ch] * (1.0f / 255.0f) - m) * inv_s;
        float t = v / scale + zpf;  // divide, matching ops/quant.quantize_u8
        t = std::min(255.0f, std::max(0.0f, t));
        plane[p] = (uint8_t)t;
      }
    }
  }
}

// First-conv ingest pre-layout: quantized u8 NCHW -> zero-point-padded +
// space-to-depth u8 blocks, one pass.  Mirrors ops/conv.py s2d_input (the
// rewrite of a stride-s conv into a stride-1 conv over s*s*C channels):
// out[i][Y][X][(r*s+t)*c + ch] = padded[i][Y*s+r][X*s+t][ch], where padded
// is the zp-padded NHWC view of the NCHW input.  Fed from the DataLoader,
// the card's forward starts at the stride-1 conv.
void i8ie_s2d_quantized(const uint8_t* q, int64_t n, int64_t c, int64_t h,
                        int64_t w, int64_t k, int64_t s, int64_t p,
                        int32_t zp, uint8_t* out) {
  const int64_t h2 = h + 2 * p, w2 = w + 2 * p;
  const int64_t kp = (k + s - 1) / s;
  const int64_t oh = (h2 - k) / s + 1, ow = (w2 - k) / s + 1;
  const int64_t HB = oh + kp - 1, WB = ow + kp - 1;  // hp/s, wp/s
  const int64_t hw = h * w;
  const uint8_t pad = (uint8_t)zp;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* src = q + i * c * hw;           // NCHW sample
    uint8_t* dst = out + i * HB * WB * s * s * c;  // [HB, WB, s*s*c]
    for (int64_t Y = 0; Y < HB; ++Y) {
      for (int64_t X = 0; X < WB; ++X) {
        uint8_t* blk = dst + (Y * WB + X) * s * s * c;
        for (int64_t r = 0; r < s; ++r) {
          const int64_t y = Y * s + r - p;
          for (int64_t t = 0; t < s; ++t) {
            const int64_t x = X * s + t - p;
            uint8_t* cell = blk + (r * s + t) * c;
            if (y < 0 || y >= h || x < 0 || x >= w) {
              for (int64_t ch = 0; ch < c; ++ch) cell[ch] = pad;
            } else {
              const uint8_t* px = src + y * w + x;
              for (int64_t ch = 0; ch < c; ++ch) cell[ch] = px[ch * hw];
            }
          }
        }
      }
    }
  }
}

}  // extern "C"
